"""Knowledge distillation (paper §2.2) and the BNN training loop.

Port of ``repro/distill/kd.py`` (``kd_loss``, ``TrainResult``,
``evaluate``, ``train_bnn``).

Loss (paper eq. 5):  L = λ·H_stu(y, q) + (1−λ)·H_tea(p^T, q^T)
with temperature-T softened teacher targets; the customized (binarized,
separable-conv) student recovers the accuracy the MPC-friendly surgery
costs.  This is the training stage of the customization pipeline
(DESIGN.md §13): teacher -> ``train_bnn`` student -> ``TrainResult.params``
-> ``core.secure_model.compile_secure``.

The step is the reference's, in its order: AdamW over every params
entry (the BN running statistics too, which get no gradient and so only
weight decay), then each running statistic blended as
``momentum * p[k] + (1 - momentum) * batch_stat`` on the value AdamW
returned.  Batches come from ``np.random.default_rng(seed).permutation``;
teacher logits from the teacher's eval-mode forward without binarization.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..nn import bnn
from ..optim import OptConfig, adamw_init, adamw_update

__all__ = ["kd_loss", "TrainResult", "evaluate", "train_bnn"]


def kd_loss(student_logits: torch.Tensor, labels: torch.Tensor,
            teacher_logits: torch.Tensor | None = None, lam: float = 1.0,
            temperature: float = 10.0) -> torch.Tensor:
    """λ=1 -> plain CE (no KD); λ<1 mixes the distillation term."""
    logp = F.log_softmax(student_logits, dim=-1)
    hard = -logp.gather(1, labels.long()[:, None]).mean()
    if teacher_logits is None or lam >= 1.0:
        return hard
    t = temperature
    p_t = F.softmax(teacher_logits / t, dim=-1)
    logq_t = F.log_softmax(student_logits / t, dim=-1)
    soft = -(p_t * logq_t).sum(-1).mean() * (t * t)
    return lam * hard + (1.0 - lam) * soft


@dataclasses.dataclass
class TrainResult:
    params: dict           # bnn.L-contract params: compile_secure's input
    history: list          # (epoch, train_loss, test_acc)
    param_count: int


def evaluate(params: dict, net: str, x, y, batch: int = 256,
             binarize: bool = True) -> float:
    """Plaintext top-1 accuracy (eval mode: running BN stats, hard Sign) on
    numpy ``(x, y)``, on the params' device.  The secure run executes the
    same eval-mode graph under MPC, so secure and plaintext accuracy agree
    outside ulp-sized Sign margins."""
    dev = next(iter(params.values())).device
    correct = 0
    for i in range(0, len(x), batch):
        logits, _ = bnn.bnn_forward(params, torch.as_tensor(
            x[i:i + batch], device=dev), net, binarize=binarize)
        correct += int((np.argmax(logits.cpu().numpy(), -1)
                        == y[i:i + batch]).sum())
    return correct / len(x)


def _train_step(params: dict, opt: dict, xb, yb, tlogits, *, net: str,
                ocfg: OptConfig, lam: float, temperature: float,
                binarize: bool, bn_momentum: float):
    """One step: (params, optimizer state, loss); AdamW updates the
    first two in place, the running statistics are new tensors."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    logits, stats = bnn.bnn_forward(leaves, xb, net, train=True,
                                    binarize=binarize)
    loss = kd_loss(logits, yb, tlogits, lam, temperature)
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                allow_unused=True)
    p2, o2, _ = adamw_update(params, dict(zip(names, grads)), opt, ocfg)
    # running BN stats updated outside the gradient path
    for k, v in stats.items():
        p2[k] = bn_momentum * p2[k] + (1 - bn_momentum) * v
    return p2, o2, loss.detach()


def train_bnn(net: str, data, *, epochs: int = 3, batch: int = 128,
              lr: float = 2e-3, lam: float = 1.0, temperature: float = 10.0,
              teacher=None, binarize: bool = True, seed: int = 0,
              bn_momentum: float = 0.9, device=None) -> TrainResult:
    """Train a (possibly binarized) net; optional KD from ``teacher`` =
    ``(teacher_params, teacher_net)``.

    ``lam`` is the eq.-5 λ (1.0 = plain CE, <1 mixes the softened teacher
    term at ``temperature``); ``binarize=False`` trains the full-precision
    teacher itself.  ``data`` = (x_tr, y_tr, x_te, y_te) numpy arrays (see
    ``data.image_dataset``).  Runs on ``device`` (the card unless "cpu")
    from ``bnn.init_bnn(seed, net)``."""
    dev = resolve_device(device)
    x_tr, y_tr, x_te, y_te = data
    params = bnn.init_bnn(seed, net, device=dev)
    opt = adamw_init(params)
    ocfg = OptConfig(lr=lr, weight_decay=1e-4, warmup_steps=20,
                     grad_clip=5.0)
    use_teacher = teacher is not None and lam < 1.0
    xt = torch.as_tensor(x_tr, device=dev)
    yt = torch.as_tensor(y_tr, device=dev).long()
    rng = np.random.default_rng(seed)
    hist = []
    n = len(x_tr)
    for ep in range(epochs):
        order = rng.permutation(n)
        losses = []
        for i in range(0, n - batch + 1, batch):
            idx = torch.as_tensor(order[i:i + batch], device=dev)
            xb, yb = xt[idx], yt[idx]
            tl = None
            if use_teacher:
                tl, _ = bnn.bnn_forward(teacher[0], xb, teacher[1],
                                        binarize=False)
            params, opt, l = _train_step(
                params, opt, xb, yb, tl, net=net, ocfg=ocfg, lam=lam,
                temperature=temperature, binarize=binarize,
                bn_momentum=bn_momentum)
            losses.append(float(l))
        acc = evaluate(params, net, x_te, y_te, binarize=binarize)
        hist.append((ep, float(np.mean(losses)), acc))
    return TrainResult(params, hist, bnn.param_count(params))
