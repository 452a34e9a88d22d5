# Copied from the JAX package: paddle_tpu/nets.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Composite networks (reference: python/paddle/fluid/nets.py —
simple_img_conv_pool, img_conv_group, sequence_conv_pool, glu,
scaled_dot_product_attention)."""

from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "glu",
           "scaled_dot_product_attention", "sequence_conv_pool"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(input, num_filters, filter_size,
                             stride=conv_stride, padding=conv_padding,
                             dilation=conv_dilation, groups=conv_groups,
                             param_attr=param_attr, bias_attr=bias_attr, act=act)
    return layers.pool2d(conv_out, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    tmp = input
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]
    n = len(conv_num_filter)

    def per(v):
        return v if isinstance(v, (list, tuple)) else [v] * n

    padding, fsize, acts, pattrs = (per(conv_padding), per(conv_filter_size),
                                    per(conv_act), per(param_attr))
    drops = per(conv_batchnorm_drop_rate)
    for i in range(n):
        act = acts[i]
        local_act = None if conv_with_batchnorm else act
        tmp = layers.conv2d(tmp, conv_num_filter[i], fsize[i],
                            padding=padding[i], param_attr=pattrs[i],
                            act=local_act)
        if conv_with_batchnorm:
            tmp = layers.batch_norm(tmp, act=act)
            if drops[i] > 0:
                tmp = layers.dropout(tmp, dropout_prob=drops[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """reference: nets.py scaled_dot_product_attention — THE attention
    primitive; multi-head split/recombine + softmax(QK^T/sqrt(d))V. On TPU
    this whole block fuses into MXU matmuls; the pallas flash-attention
    kernel (paddle_tpu/ops/pallas/) is the long-sequence fast path."""
    d_key = queries.shape[-1] // num_heads

    def split_heads(x):
        if num_heads == 1:
            return x
        b, t, d = x.shape[0], x.shape[1], x.shape[2]
        x = layers.reshape(x, [0, t, num_heads, d // num_heads])
        return layers.transpose(x, [0, 2, 1, 3])

    def combine_heads(x):
        if num_heads == 1:
            return x
        x = layers.transpose(x, [0, 2, 1, 3])
        return layers.reshape(x, [0, x.shape[1], x.shape[2] * x.shape[3]])

    q, k, v = split_heads(queries), split_heads(keys), split_heads(values)
    product = layers.matmul(q, k, transpose_y=True, alpha=d_key ** -0.5)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    return combine_heads(ctx)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    """reference: nets.py:251 `sequence_conv_pool` — sequence_conv over
    the padded [N, T, D] batch followed by sequence_pool."""
    from .layers.sequence import sequence_conv, sequence_pool

    conv_out = sequence_conv(input, num_filters=num_filters,
                             filter_size=filter_size,
                             param_attr=param_attr, bias_attr=bias_attr,
                             act=act)
    return sequence_pool(conv_out, pool_type=pool_type)
