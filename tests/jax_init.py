"""Flax variables of a JAX model, initialised under `jax.jit`.

An eager `model.init` runs the model's whole forward op by op on the CPU,
compiling every op (86 s for the reduced promptxrestormerir at (2, 64, 128,
3), 58 s for the reduced promptir at (2, 64, 96, 3), alone on the test
host). Jitted, the same init is one program (29 s and 12 s) and gives the
same variables bit for bit: the same threefry draws and initialisers, leaf
by leaf equal to the eager ones for promptir, promptxrestormerir and
promptxrestormereffir. (With LLVM's optimisation off, as test_torch_uformer.
py:run_jax builds, they are not bit-equal, so this build is the default
one.)
"""

import jax


def init_variables(model, seed: int, x):
    """`model.init(jax.random.PRNGKey(seed), x)`, jitted."""
    return jax.jit(model.init)(jax.random.PRNGKey(seed), x)
