"""Carry tables and stream state from the JAX package into the port.

The JAX package keeps its scan tables, filter weights and sniffer state
as arrays; handed over as numpy arrays (``np.asarray`` of each), these
helpers turn them into the port's tensors with the port's dtypes, so a
deployment can move a stream from one package to the other mid-capture
(``WidebandSniffer.load_state``) or check that both packages hold the
same tables.
"""

from __future__ import annotations

import numpy as np
import torch


def scan_tables_from_numpy(aa_rows, aa_mask, whiten_rows, crc_inits,
                           adv_flags, device):
    """(aa_rows (M, 32) or (32,), aa_mask (32,), whiten_rows (M, 336),
    crc_inits (M,), adv_flags (M,)) numpy -> tensors on ``device``:
    int8 AA bits, int8 care mask, int8 whitening bits, int32 table-form
    CRC inits, bool advertising flags."""
    dev = torch.device(device)
    return (torch.tensor(np.asarray(aa_rows, np.int8), device=dev),
            torch.tensor(np.asarray(aa_mask, np.int8), device=dev),
            torch.tensor(np.asarray(whiten_rows, np.int8), device=dev),
            torch.tensor(np.asarray(crc_inits, np.int32), device=dev),
            torch.tensor(np.asarray(adv_flags, bool), device=dev))


def filter_tables_from_numpy(compute_dtype: str, tables, device):
    """The fused front end's weight tables for one mode, numpy -> tensors:

      "bf16x2w": (g_chunks_hilo,) — the (n_chunks, 160, chunk*40) stacked
                 hi/lo pair, every entry bf16-representable, so the bf16
                 tensor holds it exactly;
      "f32":     (perm, kcoefx, w4x[, n_slices]) of _polyx_tables — the
                 frame-row gather as int64, the stacked taps and the DFT
                 as float32.
    """
    dev = torch.device(device)
    if compute_dtype == "bf16x2w":
        (gk,) = tables
        gk = torch.as_tensor(np.asarray(gk, np.float32))
        out = gk.to(torch.bfloat16)
        if not torch.equal(out.to(torch.float32), gk):
            raise ValueError("hi/lo weights are not bf16-representable")
        return (out.to(dev).contiguous(),)
    if compute_dtype == "f32":
        perm, kcoefx, w4x = tables[:3]
        return (torch.as_tensor(np.asarray(perm), dtype=torch.long, device=dev),
                torch.as_tensor(np.asarray(kcoefx, np.float32), device=dev).contiguous(),
                torch.as_tensor(np.asarray(w4x, np.float32), device=dev).contiguous())
    raise NotImplementedError(f"no filter tables for compute_dtype {compute_dtype!r}")
