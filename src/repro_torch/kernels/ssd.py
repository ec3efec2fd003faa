"""Mamba-2 chunked SSD scan (kernel B9): wrapper and plain version.

Port of ``repro/kernels/ssd.py`` (``ssd_scan``).  The chunk math
(:func:`ssd_chunked`) is the body of the Pallas kernel and of
``repro/nn/ssm.py::ssd_prefill``'s ``lax.scan``: within a chunk the SSM in
matrix form, across chunks a (hd, N) state carried per (batch, head).
``nn.ssm.ssd_prefill`` runs it as plain torch, as the reference runs it in
jnp; no entry point of the reference reaches the kernel, which is driven
through :func:`ssd_scan`.

On a CUDA tensor :func:`ssd_scan` launches the hand-written kernel
``csrc/ssd_scan.cu`` (it replaces the TPU kernel
``repro/kernels/ssd.py::_ssd_kernel``) or raises; on a CPU tensor it runs
the plain version.
"""
from __future__ import annotations

import torch

from . import build

__all__ = ["ssd_chunked", "ssd_scan", "ssd_scan_ref", "SMEM_LIMIT"]

SMEM_LIMIT = 232_448     # bytes of shared memory a Hopper block may use


def ssd_chunked(x, bmat, cmat, da, dt, chunk: int, state=None):
    """x (B,S,H,hd), bmat/cmat (B,S,N), da/dt (B,S,H), S % chunk == 0 ->
    (y (B,S,H,hd) float32, final state (B,H,hd,N) float32), in float32
    one chunk at a time from ``state`` (zeros by default)."""
    b, s, h, hd = x.shape
    n = bmat.shape[-1]
    assert s % chunk == 0, (s, chunk)
    if state is None:
        state = torch.zeros((b, h, hd, n), dtype=torch.float32,
                            device=x.device)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        xc, bc, cc = x[:, sl].float(), bmat[:, sl].float(), \
            cmat[:, sl].float()
        dac, dtc = da[:, sl].float(), dt[:, sl].float()
        cum = torch.cumsum(dac, dim=1)                           # (B,Q,H)
        # intra-chunk (matrix form): L[i,j] = exp(cum_i - cum_j) for i >= j
        li = cum[:, :, None, :] - cum[:, None, :, :]             # (B,Q,Q,H)
        decay = torch.where(mask[None, :, :, None], torch.exp(li), 0.0)
        scores = torch.einsum("bqn,bkn->bqk", cc, bc)
        m = scores[:, :, :, None] * decay
        xdt = xc * dtc[..., None]                                # (B,Q,H,hd)
        y = torch.einsum("bqkh,bkhd->bqhd", m, xdt)
        # contribution of the carried state
        y = y + torch.einsum("bqn,bhdn->bqhd", cc, state) \
            * torch.exp(cum)[..., None]
        tail = torch.exp(cum[:, -1:, :] - cum)                   # (B,Q,H)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] \
            + torch.einsum("bqhd,bqn,bqh->bhdn", xdt, bc, tail)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def ssd_scan_ref(x, bmat, cmat, da, dt, *, chunk: int = 64):
    """Plain version: (B,S,H,hd) in x's dtype."""
    return ssd_chunked(x, bmat, cmat, da, dt, chunk)[0].to(x.dtype)


def _sub_block(chunk: int) -> int:
    """Rows of the chunk the kernel holds at once (64, or the whole chunk
    when it is shorter)."""
    return min(chunk, 64)


def smem_bytes(chunk: int, hd: int, n: int) -> int:
    """The kernel's shared memory: the (N, hd) state, a row block of C, a
    transposed row block of B (pitch R+1), x·dt and y row blocks, the
    (R, R) intra-chunk block, and the chunk's cumsum and dt."""
    r = _sub_block(chunk)
    return 4 * (n * hd + r * n + n * (r + 1) + 2 * r * hd + r * r
                + 2 * chunk)


def _launch(x, bmat, cmat, da, dt, chunk: int):
    b, s, h, hd = x.shape
    n = bmat.shape[-1]
    r = _sub_block(chunk)
    if chunk % r:
        raise ValueError(f"ssd_scan: chunk {chunk} must be at most 64 or a "
                         f"multiple of 64")
    if smem_bytes(chunk, hd, n) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: hd {hd}, N {n}, chunk {chunk} need "
                         f"{smem_bytes(chunk, hd, n)} B of shared memory")
    if any(t.device != x.device for t in (bmat, cmat, da, dt)):
        raise ValueError("ssd_scan: inputs on different devices")
    if bmat.shape != (b, s, n) or cmat.shape != (b, s, n) \
            or da.shape != (b, s, h) or dt.shape != (b, s, h):
        raise ValueError(f"ssd_scan: shapes {tuple(x.shape)}, "
                         f"{tuple(bmat.shape)}, {tuple(cmat.shape)}, "
                         f"{tuple(da.shape)}, {tuple(dt.shape)}")
    # x, B, C are read with a unit last stride, da and dt through strides
    xf, bf, cf = (t.float() if t.stride(-1) == 1 else t.float().contiguous()
                  for t in (x, bmat, cmat))
    daf, dtf = da.float(), dt.float()
    y = torch.empty((b, s, h, hd), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y.to(x.dtype)
    fn = build.library("ssd_scan")
    err = fn(xf.data_ptr(), bf.data_ptr(), cf.data_ptr(), daf.data_ptr(),
             dtf.data_ptr(), y.data_ptr(), b, s, h, hd, n, chunk, r,
             *xf.stride()[:3], *bf.stride()[:2], *cf.stride()[:2],
             *daf.stride(), *dtf.stride(), smem_bytes(chunk, hd, n),
             build.stream_ptr(x.device))
    build.check("ssd_scan", err)
    build.LAUNCHES["ssd_scan"] += 1
    return y.to(x.dtype)


def ssd_scan(x, bmat, cmat, da, dt, *, chunk: int = 64):
    """x (B,S,H,hd), bmat/cmat (B,S,N) shared across heads, da/dt (B,S,H)
    -> y (B,S,H,hd) in x's dtype, computed in float32.  S must be a
    multiple of ``chunk`` (``ssd_prefill`` pads; this does not)."""
    s = x.shape[1]
    assert s % chunk == 0, (s, chunk)
    if x.device.type == "cuda":
        return _launch(x, bmat, cmat, da, dt, chunk)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, bmat, cmat, da, dt, chunk=chunk)
    raise ValueError(f"ssd_scan: unsupported device {x.device}")
