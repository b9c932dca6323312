"""Parameter lenses — functional optics over parameter pytrees (the
port's own copy of `jl_tpu/core/lens.py`, which is plain Python).

The reference selects the continuation parameter with Accessors.jl optics,
e.g. ``(@optic _.alpha)`` (ref src/Problems.jl:351, src/Accessors.jl).  Here a
lens is simply a key path into the parameter pytree:

* a ``str``   — dict key or dataclass/namedtuple field,
* an ``int``  — sequence index,
* a ``tuple`` — nested path of the above,
* a ``Lens``  — pre-built object with custom get/set callables.

All updates are functional (return a new params pytree) so a lens never
mutates the caller's parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

LensLike = Union[str, int, tuple, "Lens"]


@dataclasses.dataclass(frozen=True)
class Lens:
    get: Callable[[Any], Any]
    set: Callable[[Any, Any], Any]
    name: str = "custom"

    def __repr__(self):
        return f"Lens({self.name})"


def _get_one(params, key):
    if isinstance(params, dict):
        return params[key]
    if isinstance(key, int) and isinstance(params, (list, tuple)):
        return params[key]
    return getattr(params, key)


def _set_one(params, key, value):
    if isinstance(params, dict):
        new = dict(params)
        new[key] = value
        return new
    if isinstance(key, int) and isinstance(params, (list, tuple)):
        seq = list(params)
        seq[key] = value
        return type(params)(seq) if isinstance(params, tuple) else seq
    if dataclasses.is_dataclass(params):
        return dataclasses.replace(params, **{key: value})
    if hasattr(params, "_replace"):  # namedtuple
        return params._replace(**{key: value})
    raise TypeError(f"Cannot set field {key!r} on params of type {type(params)}")


def as_lens(lens: Optional[LensLike]) -> Lens:
    """Normalize any LensLike into a Lens object."""
    if lens is None:
        # identity lens: params IS the scalar parameter
        return Lens(get=lambda p: p, set=lambda p, v: v, name="identity")
    if isinstance(lens, Lens):
        return lens
    if isinstance(lens, (str, int)):
        path = (lens,)
    else:
        path = tuple(lens)

    def get(params):
        out = params
        for k in path:
            out = _get_one(out, k)
        return out

    def set_(params, value):
        return _set_path(params, path, value)

    return Lens(get=get, set=set_, name="/".join(map(str, path)))


def _set_path(params, path, value):
    if len(path) == 1:
        return _set_one(params, path[0], value)
    sub = _get_one(params, path[0])
    return _set_one(params, path[0], _set_path(sub, path[1:], value))


def lens_get(params, lens: Optional[LensLike]):
    return as_lens(lens).get(params)


def lens_set(params, lens: Optional[LensLike], value):
    return as_lens(lens).set(params, value)
