"""A minimal module layer: the part of the `flax.linen` API the models use.

Models are dataclasses whose `@compact` `__call__` creates parameters with
`self.param(...)` and calls submodules inline. `init(rng, *args)` returns
`{"params": tree}` and `apply(variables, *args, rngs=...)` runs the same
code reading that tree. Param trees are keyed exactly like flax.linen's
(`{"<submodule name>": {"kernel": ..., "bias": ...}}`, unnamed submodules
`ClassName_<i>`), so checkpoints and the HF converters see the same keys.

What it covers, and nothing more: `Module`, `compact`, `param`,
`make_rng`, `remat`, `Dense`, `LayerNorm`, `Conv`, `max_pool`, and
`jax.nn`'s initializers and `relu` under the names flax gives them.

Parameter init keys are derived from the module path (crc32 of the names)
folded into the "params" key, so a parameter's initial value depends on
its place in the tree, not on call order. `make_rng(name)` folds a
per-apply counter into the named stream, so every draw is distinct.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import zlib
from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.nn import initializers, relu  # noqa: F401  (re-exported)

_STATE = threading.local()


class _Scope:
    """One module's slot in the param tree during init or apply. Its dict
    is created on the first param write, so modules without params (e.g.
    DropPath) leave no key behind, as in flax."""

    def __init__(self, ctx: "_Context", path: Tuple[str, ...],
                 parent: Optional["_Scope"] = None, root: dict = None):
        self.ctx = ctx
        self.path = path
        self.parent = parent
        self._params = root
        self.children: dict = {}        # name -> _Scope
        # id(module) -> (module, name) for unnamed ones; holding the module
        # keeps its id from being reused by a later temporary
        self.bound: dict = {}
        self.counts: dict = {}          # class name -> next auto index

    @property
    def params(self) -> dict:
        if self._params is None:
            up = self.parent.params
            if self.ctx.init:
                self._params = up.setdefault(self.path[-1], {})
            else:
                return up.get(self.path[-1], {})
        return self._params

    def child(self, module: "Module") -> "_Scope":
        name = module.name
        if name is None:
            name = self.bound.get(id(module), (None, None))[1]
            if name is None:
                cls = type(module).__name__
                i = self.counts.get(cls, 0)
                self.counts[cls] = i + 1
                name = f"{cls}_{i}"
                self.bound[id(module)] = (module, name)
        if name not in self.children:
            self.children[name] = _Scope(self.ctx, self.path + (name,), self)
        return self.children[name]


class _Context:
    def __init__(self, params: dict, rngs: dict, init: bool):
        self.init = init
        self.rngs = rngs
        self.counter = 0
        self.root = _Scope(self, (), root=params)
        self.stack: list = []           # [(module, scope)]
        self.pending_root: Optional["Module"] = None

    def make_rng(self, name: str) -> jax.Array:
        key = self.rngs.get(name)
        if key is None and self.init:
            key = self.rngs.get("params")
        if key is None:
            raise ValueError(f"make_rng({name!r}) needs rngs={{{name!r}: key}}")
        self.counter += 1
        return jax.random.fold_in(key, self.counter)


def _ctx() -> _Context:
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        raise RuntimeError("module called outside init/apply")
    return ctx


def _scope_of(module: "Module") -> _Scope:
    for m, scope in reversed(_ctx().stack):
        if m is module:
            return scope
    raise RuntimeError(f"{type(module).__name__} is not bound: call it from "
                       "init/apply or inside a parent's __call__")


def compact(fn: Callable) -> Callable:
    """Bind `self` to its scope for the duration of the call."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        ctx = _ctx()
        if ctx.pending_root is self:
            ctx.pending_root = None
            scope = ctx.root
        elif ctx.stack:
            scope = ctx.stack[-1][1].child(self)
        else:
            raise RuntimeError("module called outside init/apply")
        ctx.stack.append((self, scope))
        try:
            return fn(self, *args, **kwargs)
        finally:
            ctx.stack.pop()

    return wrapped


def _as_rngs(rngs) -> dict:
    if rngs is None:
        return {}
    if isinstance(rngs, dict):
        return dict(rngs)
    return {"params": rngs}


def _run(module, params: dict, rngs: dict, init: bool, method, args, kwargs):
    prev = getattr(_STATE, "ctx", None)
    ctx = _STATE.ctx = _Context(params, rngs, init)
    ctx.pending_root = module
    try:
        fn = method if method is not None else type(module).__call__
        return fn(module, *args, **kwargs)
    finally:
        _STATE.ctx = prev


@functools.partial(dataclasses.dataclass, eq=False, repr=False)
class Module:
    """Dataclass base: subclasses declare fields as annotated attributes.
    Every subclass gets a keyword-only `name` field."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        ann = cls.__dict__.get("__annotations__", {})
        if "name" in ann:
            raise TypeError(f"{cls.__name__}: 'name' is reserved")
        dataclasses.dataclass(cls, eq=False, repr=False)

    def param(self, name: str, init_fn: Callable, *args) -> jax.Array:
        scope = _scope_of(self)
        if scope.ctx.init:
            if name not in scope.params:
                path = "/".join(scope.path + (name,))
                key = jax.random.fold_in(scope.ctx.rngs["params"],
                                         zlib.crc32(path.encode()))
                scope.params[name] = init_fn(key, *args)
            return scope.params[name]
        if name not in scope.params:
            raise KeyError(f"missing param {'/'.join(scope.path + (name,))}")
        return scope.params[name]

    def make_rng(self, name: str) -> jax.Array:
        return _scope_of(self).ctx.make_rng(name)

    def init(self, rngs, *args, method=None, **kwargs) -> dict:
        params: dict = {}
        _run(self, params, _as_rngs(rngs), True, method, args, kwargs)
        return {"params": params}

    def apply(self, variables: dict, *args, rngs=None, method=None,
              **kwargs):
        return _run(self, variables["params"], _as_rngs(rngs), False,
                    method, args, kwargs)


def remat(module_cls, static_argnums: Sequence[int] = (),
          prevent_cse: bool = True):
    """Subclass of `module_cls` whose `__call__` runs under
    `jax.checkpoint` in apply (init runs it plainly). `static_argnums`
    counts `self` as 0, like `flax.linen.remat`; those arguments are closed
    over instead of traced."""
    static = {i - 1 for i in static_argnums}
    inner_call = module_cls.__call__

    def __call__(self, *args):
        ctx = _ctx()
        if ctx.init:
            return inner_call(self, *args)
        scope = ctx.stack[-1][1].child(self)
        keys = {n: ctx.make_rng(n) for n in ctx.rngs}
        dyn_idx = [i for i in range(len(args)) if i not in static]

        def run(params, keys, *dyn):
            full = list(args)
            for i, a in zip(dyn_idx, dyn):
                full[i] = a
            plain = module_cls(**{f.name: getattr(self, f.name)
                                  for f in dataclasses.fields(module_cls)})
            return _run(plain, params, keys, False, inner_call, full, {})

        return jax.checkpoint(run, prevent_cse=prevent_cse)(
            scope.params, keys, *[args[i] for i in dyn_idx])

    return type(module_cls.__name__, (module_cls,),
                {"__call__": __call__, "__module__": module_cls.__module__})


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _promote(dtype, *xs):
    if dtype is None:
        dtype = jnp.result_type(*[x for x in xs if x is not None])
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        x, kernel, bias = _promote(self.dtype, x, kernel, bias)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        if bias is not None:
            y = y + bias
        return y


class LayerNorm(Module):
    """Statistics in at least float32 (E[x^2] - E[x]^2, clipped at 0);
    the result is cast to `dtype`, or to the promoted type of x and the
    params when `dtype` is None."""

    epsilon: float = 1e-6
    dtype: Any = None
    param_dtype: Any = jnp.float32

    @compact
    def __call__(self, x):
        f = x.shape[-1]
        stat_dtype = jnp.promote_types(x.dtype, jnp.float32)
        xf = x.astype(stat_dtype)
        mean = jnp.mean(xf, -1, keepdims=True)
        mean2 = jnp.mean(jnp.square(xf), -1, keepdims=True)
        var = jnp.maximum(0.0, mean2 - jnp.square(mean))
        scale = self.param("scale", initializers.ones, (f,), self.param_dtype)
        bias = self.param("bias", initializers.zeros, (f,), self.param_dtype)
        y = (x - mean) * (lax.rsqrt(var + self.epsilon) * scale) + bias
        dtype = self.dtype or jnp.result_type(x, scale, bias)
        return y.astype(dtype)


class Conv(Module):
    """N-d convolution on channels-last input; kernel (*k, in, out)."""

    features: int
    kernel_size: Tuple[int, ...] = (3, 3, 3)
    strides: Any = 1
    padding: Any = "SAME"
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()

    @compact
    def __call__(self, x):
        k = tuple(self.kernel_size)
        nd = len(k)
        strides = ((self.strides,) * nd if isinstance(self.strides, int)
                   else tuple(self.strides))
        padding = (self.padding if isinstance(self.padding, str)
                   else [tuple(p) for p in self.padding])
        kernel = self.param("kernel", self.kernel_init,
                            k + (x.shape[-1], self.features),
                            self.param_dtype)
        bias = (self.param("bias", initializers.zeros, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        x, kernel, bias = _promote(self.dtype, x, kernel, bias)
        spatial = "DHW"[-nd:] if nd <= 3 else None
        dn = ("N" + spatial + "C", spatial + "IO", "N" + spatial + "C")
        y = lax.conv_general_dilated(x, kernel, strides, padding,
                                     dimension_numbers=dn)
        if bias is not None:
            y = y + bias
        return y


def max_pool(x, window_shape: Tuple[int, ...], strides=None,
             padding: Any = "VALID"):
    """Max over windows of the spatial axes of a channels-last array."""
    nd = len(window_shape)
    strides = tuple(strides) if strides is not None else (1,) * nd
    dims = (1,) + tuple(window_shape) + (1,)
    if not isinstance(padding, str):
        padding = ((0, 0),) + tuple(tuple(p) for p in padding) + ((0, 0),)
    return lax.reduce_window(x, -jnp.inf, lax.max, dims,
                             (1,) + strides + (1,), padding)
