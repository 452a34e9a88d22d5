"""`params_from_numpy`: the JAX package's parameters carried across by
name, with no renames and no transposes."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import gpt

torch.set_num_threads(2)


def _np_params():
    jparams, _ = jgpt.init(jax.random.key(3), jgpt.GPTConfig.tiny())
    return {k: np.asarray(v) for k, v in jparams.items()}


def test_keeps_every_name_shape_and_value():
    src = _np_params()
    out = params_from_numpy(src, "cpu",
                            expected=gpt.param_shapes(gpt.GPTConfig.tiny()))
    assert set(out) == set(src)
    for k, v in src.items():
        assert out[k].dtype == torch.float32 and out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), v)
    # a copy: writing the tensor leaves the source alone
    out["wte.w"].zero_()
    assert np.abs(src["wte.w"]).sum() > 0


def test_dtype_cast_and_bf16_sources():
    src = {"w": np.array([[1.5, -2.25]], np.float32),
           "ids": np.array([3, 4], np.int32),
           "b": np.array([0.1, 7.0], ml_dtypes.bfloat16)}
    out = params_from_numpy(src, "cpu", torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int32          # ints keep their dtype
    assert out["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["b"].float().numpy(),
                                  src["b"].astype(np.float32))


def test_rejects_missing_extra_and_misshaped():
    src = _np_params()
    shapes = gpt.param_shapes(gpt.GPTConfig.tiny())
    missing = dict(src)
    del missing["ln_f.bias"]
    with pytest.raises(KeyError, match="ln_f.bias"):
        params_from_numpy(missing, "cpu", expected=shapes)
    extra = dict(src, **{"blk.router": np.zeros((4, 64, 2), np.float32)})
    with pytest.raises(KeyError, match="blk.router"):
        params_from_numpy(extra, "cpu", expected=shapes)
    bad = dict(src, **{"blk.wo": src["blk.wo"].transpose(0, 2, 1)[:, :, :8]})
    with pytest.raises(ValueError, match="blk.wo"):
        params_from_numpy(bad, "cpu", expected=shapes)


def test_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2, np.float32)}, None)
