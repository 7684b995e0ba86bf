"""The check that no module of jax or of the JAX package is loaded."""

from benchkit.checks import forbidden_modules


def test_refuses_jax_and_basal_tpu():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla_client": 1, "flax": 1,
            "basal_tpu": 1, "basal_tpu.ops.extend": 1}
    assert forbidden_modules(mods) == sorted(mods)


def test_accepts_the_port():
    mods = {"basal_tpu_torch": 1, "basal_tpu_torch.align.pipeline": 1,
            "jaxtyping": 1, "numpy": 1, "torch": 1}
    assert forbidden_modules(mods) == []
