"""Speed-of-light probes of one CUDA device: the counterpart of
``scripts/exp_sol_probe.py``.

Measures in one process the facts the other numbers are read against:

  1. the elementwise stream rate (:func:`..utils.timing.stream_gbps`, which
     counts the bytes its two kernels move) and the rate of one
     device-to-device ``copy_``;
  2. the sorter's steady rate on 40M u32 (:func:`..ops.hw_engine.sort_words`,
     ``torch.sort`` today: the bar a hand-written sort must beat);
  3. the rate of a random gather of 16M u32 (``torch.take``);
  4. E1, the staged copy through shared memory (``cuda_kernels.dma_copy``),
     at 2^24 u32: the counterpart of the TPU's manual DMA round trip.

``--canary`` times the sorter on 4M keys and stops. Prints interim lines
and one final JSON line (``"exp": "sol_probe"``). Needs a CUDA device; a
failed probe raises.

Usage: python -m radix_sorting_tpu_torch.scripts.exp_sol_probe [--canary]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import cuda_kernels as ck
from ..ops import hw_engine
from ..utils import timing


def _keys(n: int, seed: int, device) -> torch.Tensor:
    """n random u32 from a numpy seed, as an int32 plane on ``device``."""
    x = np.random.default_rng(seed).integers(0, 1 << 32, size=n, dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def probe_stream(device, n: int = 40_000_000) -> float:
    """GB/s of the elementwise stream (two passes an iteration)."""
    return timing.stream_gbps(n, reps=20, device=device)


def probe_copy(device, n: int = 40_000_000) -> float:
    """GB/s of one ``copy_`` of n u32 (8 bytes a word)."""
    x = _keys(n, 1, device)
    out = torch.empty_like(x)
    ms = timing.loop_ms(lambda: out.copy_(x), 20, 2, device)
    return 8 * n / (ms * 1e-3) / 1e9


def _sort_keys(c: torch.Tensor) -> torch.Tensor:
    (s,), _ = hw_engine.sort_words((c,), stable=False)
    return s


def probe_sorter(device, n: int = 40_000_000) -> float:
    """ms per keys-only sort of n u32."""
    return timing.steady_chain_ms(_sort_keys, _keys(n, 2, device), reps=6)


def probe_gather(device, n: int = 16_000_000) -> float:
    """Million elements a second of a random gather of n u32; every output
    word flows into the next iteration's input (through a sum), so no
    part of the gather can be skipped."""
    rng = np.random.default_rng(3)
    v = _keys(n, 3, device)
    idx = torch.from_numpy(rng.permutation(n)).to(device)
    state = [v]

    def body():
        c = state[0]
        state[0] = c ^ (torch.take(c, idx).sum() & 1).to(torch.int32)
    ms = timing.loop_ms(body, 4, 2, device)
    return n / (ms * 1e-3) / 1e6


def probe_dma(device, n: int = 1 << 24) -> float:
    """GB/s of E1 over n u32 (8 bytes a word). Each copy's input is the last
    copy's output: a dependence with no extra pass (the TPU probe's scalar
    XOR is a full elementwise pass, as long as the copy on this card)."""
    state = [_keys(n, 4, device)]

    def body():
        state[0] = ck.dma_copy(state[0])
    ms = timing.loop_ms(body, 20, 2, device)
    return 8 * n / (ms * 1e-3) / 1e9


def probe_canary(device, n: int = 4_000_000) -> float:
    """ms per keys-only sort of 4M u32: a quick health check of the card."""
    return timing.steady_chain_ms(_sort_keys, _keys(n, 9, device), reps=10)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="speed-of-light probes of one CUDA device")
    ap.add_argument("--canary", action="store_true", help="4M-key sorter rate only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_sol_probe: needs a CUDA device")
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(device)
    if args.canary:
        rec = {"probe": "canary_ms_4M", "value": probe_canary(device), "device": name}
        print(json.dumps(rec), flush=True)
        return rec
    print(json.dumps({"device": name}), flush=True)
    rec = {"exp": "sol_probe", "device": name}
    for key, probe in (("stream_GBps", probe_stream), ("copy_GBps", probe_copy),
                       ("sorter_ms_40M", probe_sorter), ("gather_Melems", probe_gather),
                       ("dma_GBps", probe_dma)):
        rec[key] = probe(device)
        print(json.dumps({"probe": key, "value": rec[key]}), flush=True)
    rec["sorter_Mkeys"] = 40_000 / rec["sorter_ms_40M"]
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
