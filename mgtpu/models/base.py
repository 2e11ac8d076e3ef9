"""The NetSpec contract — the rebuild of the reference's NETOBJ plugin
interface (`/root/reference/models/basic_model.lua:19-91`).

Every zoo model provides a NetSpec with:
  - arguments(parser): register model-specific CLI flags
    (reference `NET.arguments`, e.g. `models/cifar/nmg.lua:265-267`)
  - create_model(opt) -> model object with init/apply
  - create_loss(opt) -> jittable loss(outputs, labels) -> scalar
  - train_rule(epoch, opt) -> {"lr":..., "wd":...}
    (reference `NET.trainRule`)
  - train_metrics / test_metrics: jittable dicts of scalar metrics
    (reference `NET.trainOutput`/`NET.testOutput`)
  - stored_outputs(outputs): arrays to accumulate + dump to HDF5 in the
    test pipeline (reference's `store=true` info entries,
    `pipelines/standard/test.lua:63-89`); default none.
"""

from __future__ import annotations

from typing import Any, Dict

import jax.numpy as jnp


class NetSpec:
    name: str = "base"

    def arguments(self, parser):  # optional model flags
        pass

    def create_model(self, opt):
        raise NotImplementedError(f"{self.name}: create_model")

    def create_loss(self, opt):
        raise NotImplementedError(f"{self.name}: create_loss")

    def train_rule(self, epoch: int, opt) -> Dict[str, float]:
        raise NotImplementedError(f"{self.name}: train_rule")

    def train_metrics(self, outputs, labels, loss) -> Dict[str, Any]:
        raise NotImplementedError(f"{self.name}: train_metrics")

    def test_metrics(self, outputs, labels, loss) -> Dict[str, Any]:
        return self.train_metrics(outputs, labels, loss)

    def eval_metrics(self, outputs, labels, loss) -> Dict[str, Any]:
        # reference defines the hook but no shipped model implements it
        # (SURVEY §2.8); we default to test metrics instead of erroring.
        return self.test_metrics(outputs, labels, loss)

    def stored_outputs(self, outputs) -> Dict[str, Any]:
        return {}

    def initial_state(self, opt, model):
        """Optional hook: return (params, stats, opt_state) when the
        model carries its own weights (the torch.load pattern of
        `mnist-saliency.lua:7-15`); None = init/retrain as usual."""
        return None


# ---- loss functions (reference criteria) ----


def nll_loss(log_probs, labels):
    """ClassNLLCriterion: mean negative log-likelihood of int labels
    over models that end in log_softmax."""
    n = log_probs.shape[0]
    ll = jnp.take_along_axis(log_probs, labels[:, None].astype(jnp.int32), axis=1)
    return -jnp.mean(ll)


def bce_loss(probs, targets, eps: float = 1e-12):
    """BCECriterion: mean binary cross-entropy over ALL elements
    (torch sizeAverage semantics) on sigmoid outputs.

    Two numerical hazards, both hit on an accelerator by
    scripts/mnist-cluttered/prnmg.mnist.sh at init (residual-head
    logits reach +-17, saturating the f32 sigmoid), each needing its
    own guard:

    1. eps placement must be THNN-exact: log(x + eps) /
       log(1 - x + eps), eps added AFTER the subtraction. The
       clip(p, eps, 1-eps) variant is NOT equivalent in f32 — 1 - 1e-12
       rounds to exactly 1.0, the upper clamp no-ops, and a saturated
       sigmoid yields log(0) = -inf loss.
    2. each log argument must be guarded with maximum(., eps), NOT a
       clip of p: a backend's FUSED logistic+log codegen can push
       1 - sigmoid(z) negative under jit (eager per-op codegen cannot —
       minimal repro: jit(bce o sigmoid) at z=17 is NaN, eager finite;
       the standalone jitted sigmoid never exceeds 1, only the fused
       chain does), log(negative) is NaN, and 0 * NaN = NaN so a zero
       target cannot mask it. A clip(p, 0, 1) does NOT survive — the
       simplifier sees clamp(logistic) as a no-op and refuses it —
       while maximum(1 - p, eps) is not provably redundant and stays.

    log(maximum(x, eps)) == log(x + eps) within O(eps) everywhere
    (they differ only for x <~ eps, where both are ~log(eps)), so THNN
    parity holds. The loss is finite for every float input and the
    gradient through the sigmoid is exactly 0 where it saturates (the
    maximum selects the constant branch)."""
    p = probs.astype(jnp.float32)
    t = targets.astype(jnp.float32)
    return -jnp.mean(t * jnp.log(jnp.maximum(p, eps))
                     + (1.0 - t) * jnp.log(jnp.maximum(1.0 - p, eps)))


# ---- LR schedules (reference trainRule variants) ----


def log_linear_rule(epoch: int, n_epochs: int, start: float = 1.0, delta: float = 3.0, wd: float = 5e-4):
    """LR = 10^-((e-1)*delta/(nEpochs-1) + start): 1e-1 -> 1e-4
    (`models/cifar/nmg.lua:257-263`)."""
    denom = max(n_epochs - 1, 1)
    return {"lr": 10.0 ** -((epoch - 1) * delta / denom + start), "wd": wd}


def step_rule(epoch: int, milestones=(60, 120, 160), base: float = 0.1, decay: float = 0.2, wd: float = 5e-4):
    """LR = base * decay^#{e >= m} (`models/cifar/rnmg.lua:431-451`)."""
    k = sum(1 for m in milestones if epoch >= m)
    return {"lr": base * decay**k, "wd": wd}


def imagenet_rule(epoch: int, base: float = 0.1, decay: float = 0.1, every: int = 30, wd: float = 1e-4):
    """LR = base * decay^floor((e-1)/every) (`models/ilsvrc/rnmg.lua:376-382`)."""
    return {"lr": base * decay ** ((epoch - 1) // every), "wd": wd}
