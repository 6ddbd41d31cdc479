"""Build-and-launch probe ladder for the card.

Port of scripts/probe_pallas_compile.py, which localised failures of the
TPU's remote Mosaic compiler with a ladder of programs of growing
complexity. Here each rung checks one piece of what the port needs on the
card, and a failing rung names the piece:

  * ``plain``: a bf16 ``torch.matmul`` on the card (PyTorch and CUDA);
  * ``probe_add``: the hand-written kernel ``csrc/probe.cu`` built with the
    other sources, bound with ctypes and launched on an (8, 128) f32 tile,
    equal to ``x * 2.0`` bit for bit (kernel 10 of the TPU kernel table);
  * one rung per CUDA source (``encoder_attention.cu``, ``dtw.cu``, ...):
    ``nvcc`` compiles that source alone, so a source nvcc refuses is named
    by its rung, not hidden in a failed link of the whole library.

    python -m crisperwhisper_tpu_torch.probe [rung,rung,...]

prints ``PROBE <rung>: OK (<s> s)`` or ``PROBE <rung>: FAIL (<s> s):
<error>`` for each rung (default: all, in the order above) and exits 1 if
any failed.
"""

from __future__ import annotations

import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

from . import _build

CARD_RUNGS = ("plain", "probe_add")
RUNGS = CARD_RUNGS + _build.SOURCES


def probe_add(x: torch.Tensor) -> torch.Tensor:
    """``x * 2`` for a contiguous f32 tensor: the kernel on the card, the
    plain version for a CPU tensor."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return x * 2.0
        raise ValueError(f"probe_add: unsupported device {x.device}")
    n = x.numel()
    if x.dtype is not torch.float32 or not x.is_contiguous() or n == 0:
        raise ValueError(f"probe_add: x must be a non-empty contiguous "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    _build.launcher("cw_probe_add")(x.get_device(), x.data_ptr(),
                                    out.data_ptr(), n)
    probe_add.launches += 1
    return out


probe_add.launches = 0


def parse_rungs(arg: str | None) -> list[str]:
    """A comma list of rung names (None or "": every rung, in order)."""
    if not arg:
        return list(RUNGS)
    rungs = [r.strip() for r in arg.split(",") if r.strip()]
    unknown = [r for r in rungs if r not in RUNGS]
    if unknown:
        raise ValueError(f"unknown probe rung(s) {unknown}; choose from "
                         f"{', '.join(RUNGS)}")
    return rungs


def run_rung(name: str, device: str = "cuda") -> None:
    """Run one rung; raises when it fails. ``plain`` and ``probe_add``
    run on the card only; a source rung needs ``nvcc``."""
    if name in CARD_RUNGS:
        if torch.device(device).type != "cuda":
            raise ValueError(f"probe rung {name!r} runs on the card only, "
                             f"not on {device!r}")
        if not torch.cuda.is_available():
            raise RuntimeError(f"probe rung {name!r} needs a CUDA card, "
                               "and none is visible")
    if name == "plain":
        x = torch.randn((256, 256), device=device, dtype=torch.bfloat16)
        if not bool(torch.isfinite((x @ x).sum())):
            raise RuntimeError("bf16 matmul gave a non-finite sum")
    elif name == "probe_add":
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn((8, 128), generator=gen, device=device)
        got = probe_add(x)
        if not torch.equal(got, x * 2.0):
            raise RuntimeError("probe_add differs from x * 2.0")
    elif name in _build.SOURCES:
        with tempfile.TemporaryDirectory(prefix="cw_probe_") as tmp:
            _build.compile_object(_build.CSRC / name,
                                  Path(tmp) / (Path(name).stem + ".o"))
    else:
        raise ValueError(f"unknown probe rung {name!r}")


def probe(name: str, device: str = "cuda") -> bool:
    """Run one rung and print its line (and the traceback on failure)."""
    t0 = time.perf_counter()
    try:
        run_rung(name, device)
    except Exception as e:  # a rung's failure is its result, not the end
        print(f"PROBE {name}: FAIL ({time.perf_counter() - t0:.1f} s): "
              f"{type(e).__name__}", flush=True)
        traceback.print_exc()
        print(f"PROBE {name} FULL: {e}", flush=True)
        return False
    print(f"PROBE {name}: OK ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return True


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        rungs = parse_rungs(argv[0] if argv else None)
    except ValueError as e:
        print(f"probe: {e}", file=sys.stderr)
        return 2
    results = [probe(r) for r in rungs]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
