"""Synthetic datasets (offline: MNIST/CIFAR are not redistributable).

Port of ``repro/data/synthetic.py`` (``IMAGE_DATASETS``, ``_templates``,
``image_dataset``, ``token_stream``): numpy code, copied so the port imports
nothing of the reference; the same seed gives the same bits.

`image_dataset` builds a structured 10-class image problem of the same shape
and cardinality as MNIST/CIFAR-10: smooth class templates + per-sample
affine jitter + noise.  KD / binarization / separable-conv *trends* transfer;
absolute accuracies are not comparable to the paper (DESIGN.md §9).

`token_stream` is the LM-side infinite data pipeline: deterministic,
shardable, seekable (resume from any step: a checkpoint restores mid-stream).
"""
from __future__ import annotations

import numpy as np

IMAGE_DATASETS = {
    "mnist-syn": dict(shape=(28, 28, 1), classes=10, n_train=6000,
                      n_test=1000),
    "cifar-syn": dict(shape=(32, 32, 3), classes=10, n_train=6000,
                      n_test=1000),
}


def _templates(rng, shape, classes):
    h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    temps = []
    for cls in range(classes):
        t = np.zeros((h, w, c), np.float32)
        for _ in range(4):  # a few gaussian blobs per class
            cy, cx = rng.uniform(4, h - 4), rng.uniform(4, w - 4)
            sy, sx = rng.uniform(2, 6), rng.uniform(2, 6)
            amp = rng.uniform(0.5, 1.5) * rng.choice([-1, 1])
            blob = amp * np.exp(-(((yy - cy) / sy) ** 2
                                  + ((xx - cx) / sx) ** 2))
            ch = rng.integers(0, c)
            t[:, :, ch] += blob
        temps.append(t)
    return np.stack(temps)


def image_dataset(name: str, seed: int = 0):
    """Returns (x_train, y_train, x_test, y_test) float32 in [-1, 1]."""
    info = IMAGE_DATASETS[name]
    rng = np.random.default_rng(seed)
    temps = _templates(rng, info["shape"], info["classes"])

    def sample(n, rng):
        ys = rng.integers(0, info["classes"], n)
        h, w, c = info["shape"]
        xs = np.empty((n, h, w, c), np.float32)
        for i, y in enumerate(ys):
            dy, dx = rng.integers(-2, 3, 2)
            img = np.roll(np.roll(temps[y], dy, 0), dx, 1)
            img = img * rng.uniform(0.8, 1.2)
            img += rng.normal(0, 0.25, img.shape)
            xs[i] = img
        return np.clip(xs, -3, 3) / 3.0, ys.astype(np.int32)

    x_tr, y_tr = sample(info["n_train"], rng)
    x_te, y_te = sample(info["n_test"], np.random.default_rng(seed + 1))
    return x_tr, y_tr, x_te, y_te


def token_stream(batch: int, seq: int, vocab: int, *, seed: int = 0,
                 start_step: int = 0, shard: tuple[int, int] = (0, 1)):
    """Infinite deterministic LM batches with next-token labels.

    Seekable: iteration order is a pure function of (seed, step), so a
    restarted trainer resumes exactly.  `shard=(i, n)` yields the i-th of n
    per-host slices of each global batch (multi-host data loading).
    """
    idx, nsh = shard
    assert batch % nsh == 0
    local_b = batch // nsh
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        # Markov-ish structure so loss actually decreases: the mod-7 residue
        # walks with increments from {0,1,2} — a strict subset of Z_7, so
        # P(next residue | current) has entropy ln 3 < ln 7 and the chain is
        # learnable (uniform-over-Z_7 increments would erase the structure)
        base = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int64)
        drift = np.cumsum(rng.integers(0, 3, (batch, seq + 1)), axis=1)
        toks = ((base // 7) * 7 + drift % 7) % vocab
        toks = toks[idx * local_b:(idx + 1) * local_b].astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, step
        step += 1
