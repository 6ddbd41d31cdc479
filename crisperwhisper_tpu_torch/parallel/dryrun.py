"""Multi-rank dry run at real base geometry: the twin of the JAX package's
``__graft_entry__.dryrun_multichip``.

    python -m crisperwhisper_tpu_torch.parallel.dryrun N [--device cpu]

spawns N ranks (one card each over NCCL, or CPU ranks over gloo with
``--device cpu``), shards WhisperArch.base() bf16 over an N-rank
("data", "model") mesh, audits the partitioning, then encodes a
data-sharded mel batch, decodes 8 greedy tokens with alignment-head
capture and runs the jump times (the alignment-prep and DTW kernels on
the card), and prints the ``dryrun_multichip OK: ...`` line.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _axes(n_devices: int) -> tuple[int, int]:
    """(data, model): the model axis is 4, 2 or 1 as the JAX dry run's."""
    model = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    return n_devices // model, model


def dryrun_multichip(n_devices: int,
                     device: torch.device | str | None = None) -> str:
    """Run the dry run on ``n_devices`` ranks and return (and print) its
    OK line. ``device``: "cuda" by default, one card a rank over NCCL
    (RuntimeError naming device="cpu" when fewer cards are present);
    "cpu" runs gloo CPU ranks."""
    line = run_dryrun(n_devices, device)[0]["line"]
    print(line, flush=True)
    return line


def run_dryrun(n_devices: int,
               device: torch.device | str | None = None) -> list[dict]:
    """``dryrun_multichip``'s ranks' results: each rank's OK line and its
    kernel launches."""
    from .. import testing
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip: {n_devices} ranks need {n_devices} CUDA "
                f"cards over NCCL, have {have}; pass device=\"cpu\" for "
                "gloo CPU ranks")
    return testing.run_world(
        n_devices, "crisperwhisper_tpu_torch.parallel.dryrun:_rank",
        {"n_devices": n_devices}, device=dev.type,
        backend="nccl" if dev.type == "cuda" else "gloo", timeout=600.0)


def rank_launches(results: list[dict]) -> dict[str, int]:
    """Kernel launches summed over the ranks of a dry run's results."""
    total: dict[str, int] = {}
    for r in results:
        for name, n in r["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


def _rank(n_devices: int) -> dict:
    """One rank of the dry run (__graft_entry__.py:90-144)."""
    import torch.distributed as dist
    from ..config import GenerationOptions, SpecialTokens, WhisperArch
    from ..decoding.greedy import greedy_decode
    from ..models.whisper import alignment_selector, encode, init_params
    from ..ops import align_prep, dtw, fused_attention
    from ..ops.alignment import attention_to_jump_times
    from ..testing import gather_rows, param_bytes, rows_of
    from .mesh import make_mesh, mesh_device, shard_params

    data_axis, model_axis = _axes(n_devices)
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = make_mesh(data=data_axis, model=model_axis, device=dev_type)
    dev = mesh_device(mesh)
    arch = WhisperArch.base()        # real family geometry (d=512, 6+6)
    sp = SpecialTokens(eot=50256, sot=50257, translate=50357,
                       transcribe=50358, sot_prev=50360, no_speech=50361,
                       no_timestamps=50362, timestamp_begin=50363,
                       language_begin=50258, num_languages=99)
    opts = GenerationOptions(max_initial_timestamp_index=50)

    # the same weights on every rank, made on the host and cut there
    whole = init_params(arch, torch.Generator().manual_seed(0), "cpu",
                        torch.bfloat16)
    params = shard_params(whole, mesh)

    # ---- partitioning audit: TP must actually split the layer stacks ----
    total = param_bytes(whole)
    local = [None] * n_devices
    dist.all_gather_object(local, param_bytes(params))
    frac = sum(local) / (total * n_devices)
    limit = 1.0 if model_axis == 1 else 0.55 + 0.45 / model_axis
    assert (frac <= limit if model_axis == 1 else frac < limit), (
        f"TP did not partition: addressable/replicated={frac:.3f} "
        f">= {limit:.3f} (model_axis={model_axis})")
    for lp, wp in zip(params["encoder"]["layers"], whole["encoder"]["layers"]):
        assert lp["attn"]["q"]["w"].nbytes * model_axis \
            == wp["attn"]["q"]["w"].nbytes, \
            "attention projection is not split over the model axis"
    del whole

    batch = 2 * data_axis
    mel = np.random.default_rng(0).standard_normal(
        (batch, arch.num_mel_bins, 2 * arch.max_source_positions)
    ).astype(np.float32)
    mine = torch.from_numpy(rows_of(mel, mesh)).to(dev)
    rows = mine.shape[0]
    for wrapper in (fused_attention.fused_attention, align_prep.align_prep,
                    dtw.dtw):
        wrapper.launches = 0
    enc = encode(params, arch, mine)
    res = greedy_decode(params, arch, sp, opts, enc,
                        torch.full((rows, 1), sp.sot), max_new_tokens=8,
                        align_sel=alignment_selector(arch, ((0, 1), (1, 2))))
    jumps = attention_to_jump_times(
        res.align_probs.float(), 7, (res.num_generated - 1).clamp_min(0),
        torch.full((rows,), arch.max_source_positions, dtype=torch.int32,
                   device=dev))
    jumps.cpu()                                  # force execution
    seqs = gather_rows(res.sequences.cpu().numpy(), mesh)
    assert seqs.shape == (batch, 9), seqs.shape
    per_rank = sum(local) / n_devices
    line = (f"dryrun_multichip OK: mesh=({data_axis} data x {model_axis} "
            f"model), batch={batch}, arch=base(d={arch.d_model}, "
            f"L={arch.encoder_layers}+{arch.decoder_layers}), "
            f"params={total / 2**20:.0f} MiB, per-device "
            f"{per_rank / 2**20:.0f} MiB "
            f"(addressable/replicated={frac:.3f} < {limit:.3f})")
    return {"line": line, "launches": {
        "encoder_attention": fused_attention.fused_attention.launches,
        "align_prep": align_prep.align_prep.launches,
        "dtw": dtw.dtw.launches}}


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m "
                                 "crisperwhisper_tpu_torch.parallel.dryrun")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None,
                    help="cuda (default: one card a rank, NCCL) or cpu "
                         "(gloo CPU ranks)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
