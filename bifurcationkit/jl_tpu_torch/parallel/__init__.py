"""Multi-device path — the port of `jl_tpu/parallel/` on
`torch.distributed`: the device mesh (`mesh.py`), the roll-based
stencils (`ops.py`), the explicit halo exchanges and mesh reductions
(`halo.py`), the time-sharded COP solves (`cop.py`), the rank-local
problems of the sharded solver stack (`models.py`), the dry run's seven
legs (`dryrun.py`) and the launcher of its ranks (`launch.py`)."""
from .halo import pdot, pnorm, sharded_dia_spmv, sharded_gmres_matvec
from .mesh import make_mesh, replicated, shard_state
from .ops import periodic_laplacian_2d, sh_operator_2d
from .mesh import full_state, local_block, transport, use_mesh
from .ops import sh_residual_2d, sharded_monodromy
