"""`jax.shard_map` under the repo's historical `check_rep=` spelling.

`jax.shard_map` names that keyword `check_vma`; every in-repo site imports
`shard_map` from here and the shim renames it.
"""

from __future__ import annotations

import functools

from jax import shard_map as _shard_map


@functools.wraps(_shard_map)
def shard_map(*args, **kw):
    if "check_rep" in kw:
        kw["check_vma"] = kw.pop("check_rep")
    return _shard_map(*args, **kw)
