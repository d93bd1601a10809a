"""The JAX package's random initializers drawn with numpy, for the port's
parity tests.

`jax.random` compiles a program for every new shape it draws, and a
network built in the JAX package draws one a parameter; the parity tests
carry those weights over to the port, so where they come from does not
matter as long as both packages get the same ones. Inside
`numpy_initializers()` the JAX package's `Normal`, `TruncatedNormal` and
`Uniform` (and so the Xavier and Kaiming initializers, which call them)
draw with numpy from a seed taken from the JAX generator's next key:
`paddle_tpu.seed` still fixes every weight, and nothing is compiled.
"""
import contextlib

import numpy as np


@contextlib.contextmanager
def numpy_initializers():
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core import dtype as _dt
    from paddle_tpu.core.random import next_key
    from paddle_tpu.nn import initializer as I

    def rng():
        seed = np.asarray(jax.random.key_data(next_key()), np.uint32)
        return np.random.RandomState(seed)

    def place(v, dtype):
        return jnp.asarray(v.astype(np.float32).astype(
            jnp.dtype(_dt.convert_dtype(dtype))))

    def normal(self, shape, dtype):
        v = rng().standard_normal(tuple(shape))
        return place(v * self.std + self.mean, dtype)

    def truncated_normal(self, shape, dtype):
        r = rng()
        v = r.standard_normal(tuple(shape))
        out = np.abs(v) > 2.0
        while out.any():
            v[out] = r.standard_normal(int(out.sum()))
            out = np.abs(v) > 2.0
        return place(v * self.std + self.mean, dtype)

    def uniform(self, shape, dtype):
        return place(rng().uniform(self.low, self.high, tuple(shape)), dtype)

    saved = {c: c.__call__ for c in (I.Normal, I.TruncatedNormal, I.Uniform)}
    I.Normal.__call__ = normal
    I.TruncatedNormal.__call__ = truncated_normal
    I.Uniform.__call__ = uniform
    try:
        yield
    finally:
        for c, f in saved.items():
            c.__call__ = f
