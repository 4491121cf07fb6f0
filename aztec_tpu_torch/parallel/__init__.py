"""The parallel layer: MSMs and coset FFTs sharded over a device mesh.

Port of aztec_tpu/parallel/.  A ``Mesh`` is an ordered list of devices and
an axis name, the counterpart of a ``jax.sharding.Mesh`` with one axis: each
shard's work runs on its device from one process (the mesh may name one
card D times), and the cross-shard steps are explicit moves between the
devices (one gather of D partial points for an MSM, block moves for the
FFT's all-to-all).  ``multihost`` joins several processes over
``torch.distributed`` (gloo), each with its own local mesh.
"""

from .mesh import Mesh  # noqa: F401
from .sharded_msm import sharded_msm  # noqa: F401
