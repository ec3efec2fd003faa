"""Mamba-2 chunked SSD scan (kernel B9): wrapper and plain version.

Port of ``repro/kernels/ssd.py`` (``ssd_scan``).  The chunk math
(:func:`ssd_chunked`) is the body of the Pallas kernel and of
``repro/nn/ssm.py::ssd_prefill``'s ``lax.scan``: within a chunk the SSM in
matrix form, across chunks a (hd, N) state carried per (batch, head).
``nn.ssm.ssd_prefill`` runs it as plain torch, as the reference runs it in
jnp; no entry point of the reference reaches the kernel, which is driven
through :func:`ssd_scan`.

On a CUDA tensor :func:`ssd_scan` launches the hand-written kernels of
``csrc/ssd_scan.cu`` (they replace the TPU kernel
``repro/kernels/ssd.py::_ssd_kernel``) or raises; on a CPU tensor it runs
the plain version.  The kernels are Mamba-2's chunk decomposition in
passes: Bᵀ and Cᵀ, then C·Bᵀ once per (batch, chunk); each chunk's state
contribution; the states passed in chunk order; each chunk's output.  One
call counts one launch however many kernels it runs; any chunk that
divides S runs (up to the shared memory of :func:`smem_bytes`).
"""
from __future__ import annotations

import torch

from . import build

__all__ = ["ssd_chunked", "ssd_scan", "ssd_scan_ref", "SMEM_LIMIT",
           "smem_bytes", "scratch", "MODES"]

SMEM_LIMIT = 232_448     # bytes of shared memory a Hopper block may use


def ssd_chunked(x, bmat, cmat, da, dt, chunk: int, state=None,
                dtype: torch.dtype = torch.float32):
    """x (B,S,H,hd), bmat/cmat (B,S,N), da/dt (B,S,H), S % chunk == 0 ->
    (y (B,S,H,hd), final state (B,H,hd,N)) in ``dtype`` (float32, as the
    reference; float64 gives the tests an exact yardstick), one chunk at a
    time from ``state`` (zeros by default)."""
    b, s, h, hd = x.shape
    n = bmat.shape[-1]
    assert s % chunk == 0, (s, chunk)
    if state is None:
        state = torch.zeros((b, h, hd, n), dtype=dtype, device=x.device)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        xc, bc, cc = (t[:, sl].to(dtype) for t in (x, bmat, cmat))
        dac, dtc = da[:, sl].to(dtype), dt[:, sl].to(dtype)
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


# mirrors csrc/ssd_scan.cu: the scan's float64 totals and the cp.async stages
_HEAD_FLOATS, _STAGES_FLOATS = 16, 3 * 2 * 16 * (132 + 68)
# the C entry point's modes: all passes; one alone, for timing ("gram" is
# the transpose of B and C and the C·Bᵀ pass); the serial kernel (one block
# per (head, batch) walking the chunks)
MODES = {"passes": 0, "gram": 1, "states": 2, "pass": 3, "scan": 4,
         "serial": 5}


def smem_bytes(chunk: int) -> int:
    """Shared memory of passes (a) and (c): the float64 scan's warp totals,
    the K slabs in flight and four (chunk) vectors (two heads' cum and
    dt)."""
    return 4 * (_HEAD_FLOATS + _STAGES_FLOATS + 4 * chunk)


def scratch(b: int, s: int, h: int, hd: int, n: int, chunk: int,
            device) -> tuple:
    """The passes' buffers: C·Bᵀ per (batch, chunk) (B, nc, Q, Q), the
    (N, hd) state of every (batch, head, chunk), each chunk's total decay
    exponent (B, H, nc), and Bᵀ and Cᵀ (2, B, N, S)."""
    nc = s // chunk
    f = dict(dtype=torch.float32, device=device)
    return (torch.empty((b, nc, chunk, chunk), **f),
            torch.empty((b, h, nc, n, hd), **f), torch.empty((b, h, nc), **f),
            torch.empty((2, b, n, s), **f))


def _launch(x, bmat, cmat, da, dt, chunk: int, mode: str = "passes",
            buffers: tuple | None = None):
    """Launch B9 (``mode`` "passes"); the other modes run one pass alone on
    ``buffers`` or the serial kernel, for ``chip_smoke.py``'s timings."""
    b, s, h, hd = x.shape
    n = bmat.shape[-1]
    if smem_bytes(chunk) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {chunk} needs "
                         f"{smem_bytes(chunk)} B of shared memory")
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
    if buffers is None:   # the serial kernel needs none
        buffers = (scratch(b, s, h, hd, n, chunk, x.device)
                   if mode != "serial" else (y,) * 4)
    gt, st, cl, bct = buffers
    fn = build.library("ssd_scan")
    err = fn(xf.data_ptr(), bf.data_ptr(), cf.data_ptr(), daf.data_ptr(),
             dtf.data_ptr(), y.data_ptr(), gt.data_ptr(), st.data_ptr(),
             cl.data_ptr(), bct.data_ptr(), b, s, h, hd, n, chunk,
             *xf.stride()[:3], *bf.stride()[:2], *cf.stride()[:2],
             *daf.stride(), *dtf.stride(), MODES[mode],
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
