"""Port parity of `Model.loss` and its gradients for the hybrid (zamba2),
ssm (xlstm) and audio (whisper) families against the JAX reference: the
check of tests/test_torch_training.py (`check_arch`, with its limits and
the reason zamba2 is compared at a Mamba2 chunk of 8), run in a file of
its own so each file stays short."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):   # removed in JAX 0.9
    jax.experimental.enable_x64 = \
        lambda new_val=True: jax.enable_x64(new_val)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tests.test_torch_training import (FAMILY_ARCHS, RefModel,  # noqa: E402
                                       _batch, _pair, _ref_grads,
                                       check_arch)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    check_arch(arch)


def test_reference_zamba2_gradient_is_nan_at_its_own_chunk():
    """The reason zamba2 is compared at CHUNK = 8 (module docstring)."""
    ref_cfg, _ = _pair("zamba2-2.7b")
    params = RefModel(ref_cfg).init(jax.random.key(0))
    _, _, g = _ref_grads(ref_cfg, params, _batch(ref_cfg))
    assert not np.isfinite(g["mamba"]["w_in"]).all()
