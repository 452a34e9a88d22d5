# Copied from the JAX package: paddle_tpu/amp/fp16_lists.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""AMP op lists (reference: contrib/mixed_precision/fp16_lists.py)."""

from __future__ import annotations

# Ops that are numerically safe and fast in low precision (MXU ops).
white_list = {
    "conv2d", "depthwise_conv2d", "conv3d", "conv2d_transpose",
    "matmul", "matmul_v2", "mul", "bmm",
}

# Ops that must stay fp32 (reductions / exp / norm stats).
black_list = {
    "exp", "square", "log", "mean", "sum", "softmax",
    "softmax_with_cross_entropy", "cross_entropy", "layer_norm",
    "batch_norm", "reduce_sum", "reduce_mean",
}

gray_list = {
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "relu", "gelu", "tanh", "sigmoid", "dropout", "pool2d", "pad",
    "concat", "split", "reshape2", "transpose2", "slice", "stack",
}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set(gray_list)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
        self.black_varnames = set(custom_black_varnames or ())
