"""A flax model's ``init(PRNGKey(seed), ...)`` parameters without compiling
the init: the test helper behind the golden pins' weights in the port's
test files.

``jax.jit(module.init)`` compiles the whole init as one XLA program (for
DMCHem hundreds of fusions and threefry loops, tens of seconds on a loaded
host). Here the init is only traced, under ``jax.eval_shape``, to record
each parameter's scope path, its place in its scope's ``params`` RNG
sequence and its initializer. Each key is then derived in numpy as flax
derives it (``LazyRng``: the root key folded with the SHA-1 hash of the
scope path and the counter, threefry-2x32 as ``jax.random.fold_in``), and
each initializer is drawn from it: the convolutions' uniform variance
scaling, zeros and ones in numpy (the same bits as ``jax.random.uniform``:
its partitionable threefry bits, the mantissa trick, then one f32
multiply), any other initializer by calling it eagerly on the key. The
result is the jitted init's up to the rounding XLA's fusion may change in
the eager initializers (an ulp in a few leaves); the golden pins, coded
with the jitted init, are the check that it is close enough.

``cached_param_checks`` (and the module fixture ``flax_param_checks``,
which a test file takes in by importing it) speeds up tracing a flax
``apply``: flax checks every stored parameter's shape against
``jax.eval_shape`` of its initializer on each apply, about a third of
tracing DMC's apply; inside, that abstract value is cached per
initializer and arguments, and the same check runs against it.
"""

from __future__ import annotations

import contextlib
import hashlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import config as flax_config
from flax.core import meta as flax_meta
from flax.core import scope as flax_scope
from jax.nn import initializers as jinit

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) of uint32 arrays, as JAX computes it."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    x0 = (x0 + ks[0]).astype(np.uint32)
    x1 = (x1 + ks[1]).astype(np.uint32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1).astype(np.uint32)
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]).astype(np.uint32)
        x1 = (x1 + ks[(i + 2) % 3] + np.uint32(i + 1)).astype(np.uint32)
    return x0, x1


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in`` of a raw uint32[2] key."""
    a, b = _threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                         np.full(1, data, np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def random_bits(key, shape) -> np.ndarray:
    """``jax.random.bits`` (32-bit, partitionable threefry) of ``shape``."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = _threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in f32."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _hash(suffix) -> int:
    """flax's ``_fold_in_static`` hash of a scope path and counter."""
    m = hashlib.sha1()
    for x in suffix:
        if flax_config.flax_fix_rng_separator:
            m.update(b"\00")
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def _fans(shape):
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


_VARIANCE_SCALING = jinit.variance_scaling(1.0, "fan_in", "uniform").__code__


def _fan_in_uniform_scale(init_fn):
    """The scale of a ``variance_scaling(scale, "fan_in", "uniform")``
    initializer on the last two axes, else None."""
    if getattr(init_fn, "__code__", None) is not _VARIANCE_SCALING:
        return None
    v = inspect.getclosurevars(init_fn).nonlocals
    if (v.get("mode"), v.get("distribution"), v.get("in_axis"),
            v.get("out_axis"), v.get("batch_axis")) == (
            "fan_in", "uniform", -2, -1, ()):
        return v["scale"]
    return None


def _draw(init_fn, key, args, kwargs):
    """One initializer on a numpy key: the common ones in numpy, any other
    eagerly in JAX."""
    f32 = len(args) in (1, 2) and not kwargs and (
        len(args) == 1 or np.dtype(args[1]) == np.float32)
    if f32:
        shape = tuple(args[0])
        if init_fn is jinit.zeros:
            return np.zeros(shape, np.float32)
        if init_fn is jinit.ones:
            return np.ones(shape, np.float32)
        scale = _fan_in_uniform_scale(init_fn)
        if scale is not None:
            var = np.float32(scale / _fans(shape)[0])
            return uniform(key, shape, -1.0, 1.0) * np.sqrt(
                np.float32(3) * var)
    out = init_fn(jnp.asarray(key), *args, **kwargs)
    return jax.tree_util.tree_map(np.asarray, out)


def init_params(module, *args, seed: int = 0, **kwargs) -> dict:
    """``module.init(jax.random.PRNGKey(seed), *args, **kwargs)`` as nested
    dicts of numpy arrays, without compiling the init."""
    records = []
    param = flax_scope.Scope.param

    def recording_param(self, name, init_fn, *init_args, **init_kwargs):
        before = self.rng_counters.get("params")
        value = param(self, name, init_fn, *init_args, **init_kwargs)
        after = self.rng_counters.get("params")
        if after is not None and after != before:
            rng = self.rngs["params"]
            suffix = getattr(rng, "suffix", ())
            records.append((self.path + (name,), suffix + (after,), init_fn,
                            init_args, {k: v for k, v in init_kwargs.items()
                                        if k != "unbox"}))
        return value

    flax_scope.Scope.param = recording_param
    try:
        shapes = jax.eval_shape(
            lambda k: module.init(k, *args, **kwargs),
            jax.random.PRNGKey(seed))
    finally:
        flax_scope.Scope.param = param
    root = np.array([0, seed], np.uint32)
    params: dict = {}
    for path, suffix, init_fn, init_args, init_kwargs in records:
        key = fold_in(root, _hash(suffix)) if suffix else root
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _draw(init_fn, key, init_args, init_kwargs)
    out = {"params": params}
    want = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), shapes)
    got = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), out)
    if got != want:
        raise AssertionError("init replay: parameter tree differs from the "
                             "init's")
    return out


def _init_key(init_fn, args, kwargs):
    """A key for an initializer's abstract output: its code, closure
    contents and defaults, and the arguments; None if unhashable."""
    code = getattr(init_fn, "__code__", None)
    try:
        cells = tuple(c.cell_contents for c in init_fn.__closure__ or ()) \
            if code is not None else ()
        key = (code or init_fn, cells, getattr(init_fn, "__defaults__", None),
               args, tuple(sorted(kwargs.items())))
        hash(key)
    except (TypeError, ValueError):
        return None
    return key


@contextlib.contextmanager
def cached_param_checks():
    """flax's ``Scope.param`` for a parameter that exists, with the
    abstract value of its initializer cached (the shape check is
    flax's own)."""
    param = flax_scope.Scope.param
    cache = {}

    def cached_param(self, name, init_fn, *init_args, unbox=True,
                     **init_kwargs):
        if not self.has_variable("params", name):
            return param(self, name, init_fn, *init_args, unbox=unbox,
                         **init_kwargs)
        self.reserve(name, "params")
        value = self.get_variable("params", name)
        if unbox:
            value = flax_meta.unbox(value)
        key = _init_key(init_fn, init_args, init_kwargs)
        abs_value = cache.get(key) if key is not None else None
        if abs_value is None:
            abs_value = jax.eval_shape(lambda: init_fn(
                jax.random.key(0), *init_args, **init_kwargs))
            if key is not None:
                cache[key] = abs_value
        for val, abs_val in zip(jax.tree_util.tree_leaves(value),
                                jax.tree_util.tree_leaves(abs_value)):
            if np.shape(val) != np.shape(abs_val):
                raise flax_scope.errors.ScopeParamShapeError(
                    name, self.path_text, np.shape(val), np.shape(abs_val))
        return value

    flax_scope.Scope.param = cached_param
    try:
        yield
    finally:
        flax_scope.Scope.param = param


@pytest.fixture(autouse=True, scope="module")
def flax_param_checks():
    """``cached_param_checks`` over a test module that imports this."""
    with cached_param_checks():
        yield
