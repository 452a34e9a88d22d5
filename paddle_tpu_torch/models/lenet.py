"""LeNet / MNIST in the port: the JAX package's `models/lenet.py`
(reference: python/paddle/fluid/tests/book/test_recognize_digits.py).

Both API levels, as there: `build_program` builds the fluid static
graph (run by `Executor`), and `init`/`apply`/`loss_fn` are the native
path on a flat param dict with the JAX package's names and layouts.

Under a mesh (`models/common.py`'s helpers, by `SPLIT_AXES`, which
`init` records): `fc1` ("embed", "mlp") is column-parallel over tp,
`fc2` ("embed", None) whole, taking fc1's joined output as GSPMD
gathers it for the JAX package; `loss_fn` is the global batch's mean
under dp.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import (ParamAxes, Params, ParamStore, conv2d_nhwc, dp_mean,
                     tp_dense)

# the logical axes of the fc weights, which `init` records and `apply`
# hands to `tp_dense`: one source for both
SPLIT_AXES = {"fc1": ("embed", "mlp"), "fc2": ("embed", None)}


def build_program(pt, img_shape=(1, 28, 28), n_classes=10, lr=0.01):
    """Static-graph LeNet (conv_pool x2 + fc ladder) via `pt.layers`.
    Returns (main, startup, feeds, loss, acc)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=list(img_shape), dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        c1 = pt.layers.conv2d(input=img, num_filters=20, filter_size=5, act="relu")
        p1 = pt.layers.pool2d(input=c1, pool_size=2, pool_stride=2, pool_type="max")
        c2 = pt.layers.conv2d(input=p1, num_filters=50, filter_size=5, act="relu")
        p2 = pt.layers.pool2d(input=c2, pool_size=2, pool_stride=2, pool_type="max")
        fc1 = pt.layers.fc(input=p2, size=500, act="relu")
        logits = pt.layers.fc(input=fc1, size=n_classes)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        acc = pt.layers.accuracy(input=pt.layers.softmax(logits), label=label)
        pt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, ("img", "label"), loss, acc


def init(generator: torch.Generator, n_classes: int = 10, device=None
         ) -> Tuple[Params, ParamAxes]:
    """Random f32 params with the JAX package's names, shapes and scales
    (not its values). `device` defaults to cuda (see `resolve_device`)."""
    from .. import resolve_device

    s = ParamStore(generator, resolve_device(device))
    s.conv("conv1", 5, 5, 1, 20)
    s.conv("conv2", 5, 5, 20, 50)
    s.dense("fc1", 4 * 4 * 50, 500, axes=SPLIT_AXES["fc1"])
    s.dense("fc2", 500, n_classes, axes=SPLIT_AXES["fc2"])
    return s.params, s.axes


def apply(params: Params, img: torch.Tensor) -> torch.Tensor:
    """img: [B, 1, 28, 28] -> logits [B, 10]."""
    x = img.permute(0, 2, 3, 1)  # NHWC, as the JAX package
    for name in ("conv1", "conv2"):
        x = torch.relu(conv2d_nhwc(x, params[f"{name}.w"], padding="VALID"))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    x = x.reshape(x.shape[0], -1)
    x = tp_dense(params, "fc1", x, SPLIT_AXES["fc1"], act=torch.relu)
    return tp_dense(params, "fc2", x, SPLIT_AXES["fc2"])


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], rng=None
            ) -> torch.Tensor:
    """Mean softmax cross-entropy of batch["img"] against
    batch["label"]; `rng` is unused, as in the JAX package."""
    logits = apply(params, batch["img"]).to(torch.float32)
    labels = batch["label"].reshape(-1)
    logp = torch.log_softmax(logits, dim=-1)
    return -dp_mean(torch.take_along_dim(logp, labels[:, None], 1))
