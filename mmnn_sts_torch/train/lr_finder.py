"""Leslie Smith's learning-rate range test (counterpart of the JAX
package's train/lr_finder.py:34-120).

On a fresh 80/20 split of the cohort (``np.random.default_rng(seed)``'s
permutation), a model built without blending takes ``num_iters`` steps
with SGD-nesterov (the config's momentum and weight decay) at a learning
rate that grows exponentially from ``lr_start`` to ``lr_end``: step ``i``
takes ``lr_start * (lr_end / lr_start) ** (i / num_iters)``, in float32 as
``optax.exponential_decay`` computes it. A step is one survival superstep
of one microbatch of ``train_batch_size`` (or one classification step, with
``pos_weight`` ones), augmented as training is; the ragged tail of an epoch
is wrap-padded and, as in the JAX package, not masked. The loss is smoothed
(``smoothing``, an exponential moving average), lr_finder.png is drawn in
``output_dir`` where matplotlib is installed, and the learning rate of the
least smoothed loss is logged. The sweep ends at rates where the loss is
inf or NaN; nothing here asks for finite values. Under a ``mesh`` of ranks
each step shards its microbatch over the ``data`` axis
(``train/steps.py``), every rank logs the same sweep and rank 0 draws it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.loader import EpochBatcher, gather_superbatch
from ..models import build_model
from ..parallel.mesh import is_writer
from ..pipeline import make_split_dataset
from ..utils.logging import get_logger
from ..utils.plotting import save_lr_finder_curve
from .state import create_train_state
from .steps import classification_train_step, survival_train_superstep


def exponential_schedule(lr_start: float, lr_end: float, num_iters: int):
    """``optax.exponential_decay(lr_start, transition_steps=1,
    decay_rate=(lr_end / lr_start) ** (1 / num_iters))`` as a function of
    the step, in float32: the rate's power rounded once to float32 (as
    XLA's ``pow`` rounds it; numpy's float32 ``power`` is up to 2 ulp off),
    then the product in float32."""
    init = np.float32(lr_start)
    rate = np.float32((lr_end / lr_start) ** (1.0 / num_iters))

    def schedule(step: int) -> float:
        if step <= 0:
            return float(init)
        return float(init * np.float32(np.float64(rate) ** step))

    return schedule


def find_lr(cfg, flags, bundle, device, lr_start: float = 1e-7,
            lr_end: float = 100.0, num_iters: int = 100,
            smoothing: float = 0.05, output_dir: str = ".", mesh=None):
    """Run the sweep on ``device``; returns ``(lrs, smoothed losses)``,
    one entry per step."""
    hp = cfg.hyperparameters
    rng = np.random.default_rng(hp.seed)
    uids = np.asarray(bundle.uids)
    order = rng.permutation(len(uids))
    train_uids = uids[order[:int(0.8 * len(uids))]]
    train_ds = make_split_dataset(cfg, flags, bundle, train_uids, device)

    torch.manual_seed(hp.seed)
    model = build_model(cfg, flags.images, flags.preop, flags.postop,
                        False).to(device)
    schedule = exponential_schedule(lr_start, lr_end, num_iters)
    optimizer = torch.optim.SGD(model.parameters(), lr=schedule(0),
                                momentum=hp.momentum, nesterov=True,
                                weight_decay=hp.weight_decay)
    state = create_train_state(model, optimizer, schedule, seed=hp.seed,
                               mesh=mesh)

    batcher = EpochBatcher(train_ds.num_samples, hp.train_batch_size, 1,
                           seed=hp.seed)
    pos_weight = None
    if not flags.survival:
        pos_weight = torch.ones(train_ds.labels.shape[-1], device=device)
    lrs, losses = [], []
    avg_loss = None
    epoch = 0
    while len(lrs) < num_iters:
        for idx in batcher.epoch_indices(epoch):
            if len(lrs) >= num_iters:
                break
            batch = gather_superbatch(train_ds, idx)
            if flags.survival:
                inputs = batch["inputs"]
                inputs = ({k: v[None] for k, v in inputs.items()}
                          if isinstance(inputs, dict) else inputs[None])
                aux = survival_train_superstep(
                    state, inputs, batch["events"][None],
                    batch["durations"][None], blend=False)
            else:
                aux = classification_train_step(
                    state, batch["inputs"], batch["labels"], pos_weight,
                    blend=False)
            loss = float(aux["loss"])
            avg_loss = loss if avg_loss is None else (
                smoothing * loss + (1 - smoothing) * avg_loss)
            lrs.append(schedule(len(lrs)))
            losses.append(avg_loss)
        epoch += 1

    if is_writer(state.mesh):
        save_lr_finder_curve(lrs, losses, output_dir)
    best = lrs[int(np.nanargmin(losses))]
    get_logger().info(f"lr_finder: min-loss lr = {best:.2e}")
    return lrs, losses
