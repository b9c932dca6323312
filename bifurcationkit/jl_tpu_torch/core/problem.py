"""Problem layer — the port of `jl_tpu/core/problem.py` (ref src/Problems.jl).

`BifurcationProblem(F, u0, params, lens)` holds the residual `F(u, params)`
plus optional user derivatives; what is missing is synthesised with
`torch.func` (ref src/Problems.jl:141-184):

* jacobian-vector products  -> `torch.func.jvp`  (or the model's `jac_op`)
* adjoint products          -> `torch.func.vjp`
* dense jacobian            -> `torch.func.jacfwd` over the raveled state
* dF/dp                     -> `torch.func.jvp` through the lens (exact)
* d2F, d3F                  -> nested `torch.func.jvp` (or the user's forms)
* d4F, d5F                  -> nested `torch.func.jvp` of F; their complex
                               extensions batch the 2^k re/im combinations
                               in one `torch.func.vmap`

The problem object is static configuration; the dynamic data (u, params)
is always passed explicitly.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional

import torch
from torch.func import jacfwd, jvp, vjp, vmap

from .lens import LensLike, lens_get, lens_set
from .state import ravel

Pytree = Any


def _default_record(x, p, **kwargs):
    flat, _ = ravel(x)
    return {"param": p, "norm": torch.linalg.vector_norm(flat)}


def _as_param_tensor(p0, like: torch.Tensor) -> torch.Tensor:
    if isinstance(p0, torch.Tensor):
        return p0.to(device=like.device)
    return torch.as_tensor(p0, dtype=like.dtype, device=like.device)


def re_im_rows(dxs):
    """The real evaluations that extend a real multilinear form to the
    directions `dxs`, complex ones split into real and imaginary parts:
    (rows, weights), one tuple of real directions per row and its weight
    i^(number of imaginary parts); a real direction enters once."""
    parts = [(d.real, d.imag) if d.is_complex() else (d, None) for d in dxs]
    rows, weights = [], []
    for c in itertools.product((0, 1), repeat=len(dxs)):
        if all(parts[i][k] is not None for i, k in enumerate(c)):
            rows.append(tuple(parts[i][k] for i, k in enumerate(c)))
            weights.append(1j ** sum(c))
    return rows, weights


def weighted_sum(terms, weights):
    """sum_r weights[r] terms[r] in complex128, `terms` stacked on dim 0."""
    w = torch.tensor(weights, dtype=torch.complex128, device=terms.device)
    return torch.tensordot(w, terms.to(torch.complex128), dims=1)


@dataclasses.dataclass(frozen=True, eq=False)
class BifurcationProblem:
    """Bifurcation problem F(u, params) = 0 continued in `lens_get(params, lens)`
    (ref `BifurcationProblem` constructor, src/Problems.jl:439-512)."""

    F: Callable[[Pytree, Any], Pytree]
    u0: Pytree = None
    params: Any = None
    lens: Optional[LensLike] = None

    # optional user-supplied derivatives (ref BifFunction, src/Problems.jl:89-184)
    jac: Optional[Callable] = None          # (u, params) -> dense matrix
    # (u, params) -> (v -> J v) operator on a tensor state u; the operator
    # takes v of shape u.shape or a batch (K, *u.shape), so the eigensolver
    # applies J to a whole block in one call
    jac_op: Optional[Callable] = None
    jac_adjoint: Optional[Callable] = None  # (u, params) -> (v -> J^T v)
    d2F_user: Optional[Callable] = None     # (u, params, dx1, dx2)
    d3F_user: Optional[Callable] = None     # (u, params, dx1, dx2, dx3)
    dFdp_user: Optional[Callable] = None    # (u, params) -> dF/d(lens param)

    # hooks (ref src/Problems.jl:458-476)
    record_from_solution: Callable = _default_record
    save_solution: Optional[Callable] = None
    update: Optional[Callable] = None       # problem update hook along branch

    # --- residual / parameter access ------------------------------------
    def residual(self, u, params):
        return self.F(u, params)

    def get_lens_param(self, params):
        return lens_get(params, self.lens)

    def set_lens_param(self, params, value):
        return lens_set(params, self.lens, value)

    @property
    def param_value(self):
        return self.get_lens_param(self.params)

    # --- jacobians -------------------------------------------------------
    def jacobian(self, u, params):
        """Dense jacobian as a 2-D tensor over the raveled state."""
        if self.jac is not None:
            return self.jac(u, params)
        flat, unravel = ravel(u)

        def f_flat(v):
            return ravel(self.F(unravel(v), params))[0]

        return jacfwd(f_flat)(flat)

    def jacobian_operator(self, u, params):
        """Matrix-free jacobian: returns `v -> J(u, params) v`."""
        if self.jac_op is not None:
            return self.jac_op(u, params)

        def op(v):
            return self.dF(u, params, v)

        return op

    def dF(self, u, params, v):
        """J(u, params) @ v, through `jac_op` when the model supplies one."""
        if self.jac_op is not None:
            return self.jac_op(u, params)(v)
        return jvp(lambda x: self.F(x, params), (u,), (v,))[1]

    def dFt(self, u, params, v):
        """J(u, params)^T @ v via vjp (real transpose, not conjugate)."""
        if self.jac_adjoint is not None:
            return self.jac_adjoint(u, params)(v)
        _, vjp_fn = vjp(lambda x: self.F(x, params), u)
        return vjp_fn(v)[0]

    def dFdp(self, u, params):
        """Exact dF/dp through the lens via jvp (replaces the reference's
        finite differences, src/continuation/Palc.jl:222)."""
        if self.dFdp_user is not None:
            return self.dFdp_user(u, params)
        like = ravel(u)[0]
        p0 = _as_param_tensor(self.get_lens_param(params), like)

        def f_of_p(p):
            return self.F(u, self.set_lens_param(params, p))

        return jvp(f_of_p, (p0,), (torch.ones_like(p0),))[1]

    # --- higher-order derivatives (jets) ---------------------------------
    def d2F(self, u, params, dx1, dx2):
        """Bilinear form d^2F(u)[dx1, dx2] (ref `BilinearMap`,
        src/Problems.jl:677-694)."""
        if self.d2F_user is not None:
            return self.d2F_user(u, params, dx1, dx2)

        def jv(x):
            return jvp(lambda y: self.F(y, params), (x,), (dx1,))[1]

        return jvp(jv, (u,), (dx2,))[1]

    def d3F(self, u, params, dx1, dx2, dx3):
        """Trilinear form d^3F(u)[dx1, dx2, dx3] (ref `TrilinearMap`,
        src/Problems.jl:696-712)."""
        if self.d3F_user is not None:
            return self.d3F_user(u, params, dx1, dx2, dx3)

        def j2(x):
            def jv(y):
                return jvp(lambda z: self.F(z, params), (y,), (dx1,))[1]

            return jvp(jv, (x,), (dx2,))[1]

        return jvp(j2, (u,), (dx3,))[1]

    def d4F(self, u, params, dx1, dx2, dx3, dx4):
        """Quadrilinear form d^4F(u)[dx1..dx4]: four nested jvps of F (the
        user's d2F/d3F are not consulted, as in the JAX package)."""
        def j3(x):
            def j2(y):
                def jv(z):
                    return jvp(lambda w: self.F(w, params), (z,), (dx1,))[1]

                return jvp(jv, (y,), (dx2,))[1]

            return jvp(j2, (x,), (dx3,))[1]

        return jvp(j3, (u,), (dx4,))[1]

    def d5F(self, u, params, dx1, dx2, dx3, dx4, dx5):
        """Quintilinear form d^5F(u)[dx1..dx5]: a jvp of `d4F`."""
        return jvp(lambda x: self.d4F(x, params, dx1, dx2, dx3, dx4),
                   (u,), (dx5,))[1]

    def _multilinear_complex(self, form, u, params, *dxs):
        """A real multilinear form extended to complex directions by
        multilinearity: the real evaluations on the re/im parts
        (`re_im_rows`) run as one `vmap`; the result is complex."""
        rows, weights = re_im_rows(dxs)
        cols = [torch.stack(c) for c in zip(*rows)]
        terms = vmap(lambda *ds: form(u, params, *ds))(*cols)
        return weighted_sum(terms, weights)

    def d4F_complex(self, u, params, *dxs):
        return self._multilinear_complex(self.d4F, u, params, *dxs)

    def d5F_complex(self, u, params, *dxs):
        return self._multilinear_complex(self.d5F, u, params, *dxs)

    # hooks that close over the functional and the state shape; carrying
    # them onto a problem with a different F or state shape would apply a
    # stale operator, so `re_make` drops them then
    _SHAPE_COUPLED_HOOKS = frozenset({"spectral_precond", "batched_F",
                                      "po_spectral_data", "n_global"})

    def re_make(self, **kwargs):
        """dataclasses.replace + carry over the non-field hooks
        (`spectral_precond`) set with object.__setattr__ (ref re_make,
        src/Problems.jl:576-617)."""
        new = dataclasses.replace(self, **kwargs)
        shape_changed = "F" in kwargs
        if not shape_changed and kwargs.get("u0") is not None \
                and self.u0 is not None:
            shape_changed = (ravel(kwargs["u0"])[0].shape
                             != ravel(self.u0)[0].shape)
        field_names = {f.name for f in dataclasses.fields(self)}
        for key, val in self.__dict__.items():
            if key not in field_names and key not in new.__dict__:
                if shape_changed and key in self._SHAPE_COUPLED_HOOKS:
                    continue
                object.__setattr__(new, key, val)
        return new

    # hashing by identity: problems are static configuration objects
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


# Aliases matching the reference's ODE/PDE constructors
# (src/Problems.jl:514-530)
ODEBifProblem = BifurcationProblem
PDEBifProblem = BifurcationProblem
