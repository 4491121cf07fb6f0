"""The circuits the configurations name (a configuration's ``circuit`` key is
a module here).  Each module has

- ``build(config, seed, device)``: the circuit built on the port's composer
  from the values the seed gives (set-up, the program under test);
- ``reference(config, seed, composer)``: the same circuit as plain data
  (``reference.keys.Circuit``) for the reference.

Where every request proves the set-up circuit again, that is all.  A module
whose requests each carry an input of their own also has

- ``draw(config, seed, index)``: request ``index``'s input and the public
  inputs its proof must carry, drawn from the seed and the index (the
  requester's part of the work, outside the request's clock);
- ``build_request(config, input, device, shared)``: that request's circuit
  on a new composer, ``shared`` the set-up composer whose SRS factory every
  request shares; ``reference`` then reads each request's composer too.

A module imports the port only inside its functions.
"""

from ..reference.keys import SELECTORS, Circuit


def turbo_circuit(composer) -> Circuit:
    """A Turbo composer's gates as plain data: what the port's stdlib built,
    read after the key (the key's set-up appends Turbo's dummy gate)."""
    return Circuit(
        "turbo", list(composer.variables), composer.real_variable_index,
        list(composer.public_inputs),
        tuple(list(w) for w in (composer.w_l, composer.w_r, composer.w_o,
                                composer.w_4)),
        {name: list(getattr(composer, name)) for name in SELECTORS["turbo"]})
