"""The circuits the configurations name (a configuration's ``circuit`` key is
a module here).  Each module has

- ``build(config, seed, device)``: the circuit built on the port's composer
  from the values the seed gives (set-up, the program under test);
- ``reference(config, seed, composer)``: the same circuit as plain data
  (``reference.keys.Circuit``) for the reference.

A module imports the port only inside ``build``.
"""
