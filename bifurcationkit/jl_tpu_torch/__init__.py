"""bifurcationkit.jl_tpu_torch — the PyTorch/CUDA port of
`bifurcationkit.jl_tpu`.

Same layout and names as the JAX package (`core/`, `linalg/`, `newton.py`,
`deflation.py`, `models/`, `ops/`, `continuation/`, `detection/`,
`normal_forms/`, `codim2/`, `periodic/`, `wave/`, `bvp/`, `utils/`,
`native/`); plain PyTorch inside:
functions on tensors, frozen dataclasses for solver configs, explicit
`device=`/`dtype=` and explicit `torch.Generator`s.  The JAX package's
Pallas kernels are CUDA C++ kernels for Hopper: the fused Swift-Hohenberg
J.v (`csrc/sh_jv.cu`, bound in `ops/sh_jv.py`) and the DIA sparse
matrix-vector product (`csrc/dia_spmv.cu`, bound in `ops/dia_spmv.py`).

Defaults mirror the JAX package's x64 switch (`jl_tpu/__init__.py`): f64
is the default dtype, passed explicitly (never through
`torch.set_default_dtype`).  Entry points run on the card unless the
caller passes `device="cpu"`; asking for the card where there is none
raises.  TF32 stays off in every solve chain: reduced matmul precision
inside the Krylov/Rayleigh-Ritz chains silently stalls convergence.
"""
import torch as _torch

DEFAULT_DTYPE = _torch.float64


def check_tf32_off():
    """Raise if TF32 matmuls were switched on (they cut the f32 Krylov and
    Rayleigh-Ritz chains to ~3 digits)."""
    if _torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "bifurcationkit.jl_tpu_torch needs "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def resolve_device(device=None) -> _torch.device:
    """`None` means the card; a CUDA device that is not there raises."""
    dev = _torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run "
            "the port on the CPU")
    return dev


check_tf32_off()

from .core import (BifurcationProblem, BorderedState, ContinuationPar,  # noqa: E402
                   DotTheta, Lens, NewtonPar, ODEBifProblem, PDEBifProblem,
                   as_lens, lens_get, lens_set, setfield)
from .linalg import (ArnoldiEig, BiCGStab, BlockJacobiPrecond,  # noqa: E402
                     DenseEig, DenseGEig, DenseLS, EigenMassMatrix,
                     FlatOperator, GMRES, IterativeGEig,
                     IterativeRefinement, LOBPCGEig, PartialSchurPrecond,
                     ShiftInvertEig, SubspaceEig, dense_gev, gev)
from .linalg.bordered import (BorderingBLS, LSFromBLS, MatrixBLS,  # noqa: E402
                              MatrixFreeBLS)
from .newton import (NonLinearSolution, cb_max_norm,  # noqa: E402
                     cb_max_norm_and_dp, newton)
from .continuation import (AutoSwitch, Bordered, Branch,  # noqa: E402
                           ContIterable, ContResult, ContState, DCResult,
                           DefCont, MoorePenrose, Multiple, Natural, PALC,
                           Polynomial, Secant, continuation,
                           deflated_continuation, merge_branches)
from .deflation import (DeflationOperator, deflated_newton,  # noqa: E402
                        deflated_problem)
from .detection import (ContinuousEvent, DiscreteEvent,  # noqa: E402
                        PairOfEvents, SetOfEvents, SpecialPoint,
                        bif_detect_event, fold_detect_event, save_at_event)
from .ops import BSRMatrix, DIAMatrix, ELLMatrix, dia_spmv  # noqa: E402
from .utils import (load_branch, plot_bifurcation_diagram,  # noqa: E402
                    plot_branch, plot_periodic_orbit, resume_data,
                    save_branch, save_every_step, savefig)
from .wave import travelling_wave_problem  # noqa: E402
from .bvp import (BVPCollocation, BVPModel, BVPShooting,  # noqa: E402
                  BVPTrapezoid, bvp_problem, discretize)
from .normal_forms import (BifDiagNode, bautin_normal_form,  # noqa: E402
                           bifurcationdiagram, continuation_from_bp,
                           get_normal_form, hopf_normal_form,
                           multicontinuation, predictor)
from .codim2 import (bautin_unfolding, bt_normal_form,  # noqa: E402
                     bt_predictors, bt_unfolding, continuation_fold,
                     continuation_fold_mf, continuation_hopf,
                     continuation_hopf_mf, cusp_normal_form,
                     fold_ma_problem, fold_ma_problem_mf,
                     get_normal_form_codim2, hh_normal_form, hh_unfolding,
                     hopf_ma_problem, hopf_ma_problem_mf, newton_bt,
                     newton_fold, newton_hopf, predictor_fold_po,
                     predictor_homoclinic_bt, predictor_ns_hh,
                     predictor_ns_zh, refine_gh, switch_codim2,
                     switch_codim2_mf, switch_codim2_po, zh_normal_form,
                     zh_unfolding)
from .periodic import (COPBLS, COPLS, Collocation,  # noqa: E402
                       FloquetColl, FloquetEig, FloquetGEV, FloquetQaDMF,
                       Flow, PoincareShooting, Shooting, Trapeze,
                       collocation_block_jacobian,
                       continuation_from_hopf_point, continuation_hopf_po,
                       continuation_po, floquet_multipliers,
                       get_periodic_orbit, monodromy_from_maps, newton_po,
                       orbit_from_branch, periodic_orbit_problem)
from .periodic import (bp_po_branch_switch, continuation_fold_po,  # noqa: E402
                       continuation_ns, continuation_pd, cop_solve,
                       cop_solve_bordered, get_normal_form_po,
                       neimark_sacker_iooss, pd_branch_switch,
                       period_doubling_iooss, po_codim2_test_values,
                       poincare_return_map)

__version__ = "0.1.0"

_LAZY_SUBMODULES = ("models", "ops", "linalg", "detection", "continuation",
                    "normal_forms", "codim2", "periodic", "core", "interop",
                    "wave", "bvp", "utils", "native", "parallel")


def __getattr__(name):
    # lazy submodule access (`bkt.models.swift_hohenberg_2d(...)`) without
    # paying the import cost of every model/kernel at package import time
    if name in _LAZY_SUBMODULES:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
