"""PyTorch port: parallel/ (tensor- and data-parallel serving over a
("data", "model") mesh) against the JAX package, in gloo worlds of CPU
ranks at the TINY geometry (4 heads: at model=2 the alignment heads
((0, 1), (1, 3), (0, 2)) fall on both ranks).

Each world is spawned once for the module and runs every scenario
(crisperwhisper_tpu_torch.testing.parallel_scenarios); the tests read its
results. The JAX references are computed here, unsharded, and the inputs
go to the children as an .npz; the children import no JAX. The
counterparts of tests/test_parallel.py's and tests/test_multihost_dcn.py's
tests, plus the dry run, kernel 5's gate on a mesh and the unsharded
path's freedom from collectives."""

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from helpers import TINY_SPECIALS, rand_mel, tiny_arch
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)
from torch_port_fixtures import (CHUNK_S, SR, TS_BAND, tone_audio,
                                 write_tiny_checkpoint)

WORLDS = (2, 4)                  # ranks; the model axis is 2 in both
WORLD_LIMIT_S = 240.0
ENC_BAND = 2e-5                  # tests/test_multihost_dcn.py's band


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"jax/{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX references, and the results of every rank of a world of 2
    (mesh 1x2) and of 4 (mesh 2x2, its ranks on two hosts of 2 as torchrun
    lays them out: LOCAL_WORLD_SIZE=2)."""
    from crisperwhisper_tpu.config import (GenerationOptions,
                                           PipelineOptions)
    from crisperwhisper_tpu.decoding import greedy_decode_jit
    from crisperwhisper_tpu.hub import load_pipeline as jax_load
    from crisperwhisper_tpu.models import encode, init_params
    from crisperwhisper_tpu.models.quantize import quantize_decoder_weights
    from crisperwhisper_tpu_torch import testing
    tmp = tmp_path_factory.mktemp("parallel")
    ckpt = write_tiny_checkpoint(str(tmp / "ckpt"))
    arch = tiny_arch()
    params = init_params(arch, jax.random.PRNGKey(1))
    mel = rand_mel(batch=4, seed=3)
    audio = tone_audio(11.0, 5)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, mel=mel, audio=audio, **_flat(jax.device_get(params)))

    def launch(world):
        out = tmp / f"world{world}"
        out.mkdir()
        res = testing.run_world(
            world, "crisperwhisper_tpu_torch.testing:parallel_scenarios",
            {"ckpt": ckpt, "inputs": inputs, "out": str(out), "model": 2},
            timeout=WORLD_LIMIT_S,
            env={"LOCAL_WORLD_SIZE": "2"} if world == 4 else None)
        return res, str(out)

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {w: pool.submit(launch, w) for w in WORLDS}
        opts = GenerationOptions(max_initial_timestamp_index=50)
        prompt = jnp.full((4, 1), TINY_SPECIALS.sot, jnp.int32)
        enc = encode(params, arch, jnp.asarray(mel))
        ref = jax.device_get(greedy_decode_jit(params, arch, TINY_SPECIALS,
                                               opts, enc, prompt, 8))
        q8 = quantize_decoder_weights(params)
        ref8 = jax.device_get(greedy_decode_jit(
            q8, arch, TINY_SPECIALS, opts, encode(q8, arch, jnp.asarray(mel)),
            prompt, 8, cross_cache_dtype=jnp.int8))
        jp = jax_load(ckpt, dtype=jnp.float32, pipe_opts=PipelineOptions(
            chunk_length_s=CHUNK_S, batch_size=2, return_timestamps="word"))
        jp.gen_opts = replace(
            jp.gen_opts, alignment_heads=((0, 1), (1, 3), (0, 2)),
            median_filter_width=7, max_initial_timestamp_index=50,
            compression_ratio_threshold=None, logprob_threshold=None,
            no_speech_threshold=None, temperatures=(0.0,), max_new_tokens=16,
            staged_ring_quantum=0)
        jax_pipe = jp({"raw": audio, "sampling_rate": SR},
                      return_timestamps="word")
        worlds = {w: f.result() for w, f in futures.items()}
    return {"worlds": worlds, "enc": np.asarray(enc), "greedy": ref,
            "int8": ref8, "pipeline": jax_pipe, "mel": mel}


def _world(run, world):
    return run["worlds"][world][0]


def _walk(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, path + (k,))
    elif isinstance(node, (list, tuple)) and node and \
            not isinstance(node[0], (str, type(None))):
        for i, v in enumerate(node):
            yield from _walk(v, path + (i,))
    else:
        yield path, node


# the logical axis of each dimension of a layer leaf: the JAX package's
# stacked layout and the port's per-layer one
_JAX_AXES = {"w": (None, "d_in", "d_out"), "w_q": (None, "d_in", "d_out"),
             "w_scale": (None, None, "d_out"), "b": (None, "d_out"),
             "w_q4": (None, "G", None, "d_out"),
             "w_gscale": (None, "G", "d_out")}
_PORT_AXES = {"w": ("d_out", "d_in"), "w_q": ("d_out", "d_in"),
              "w_scale": ("d_out",), "b": ("d_out",),
              "w_q4": ("d_out", "G", None), "w_gscale": ("d_out", "G")}


def _split_axis(spec, axes):
    named = [axes[i] for i, a in enumerate(spec) if a == "model"]
    assert len(named) <= 1
    return named[0] if named else None


@pytest.mark.parametrize("kind", ["plain", "int8", "int4", "fused"])
def test_param_pspecs_split_the_same_axes_as_jax(kind):
    """Every leaf of the plain, int8, group-wise int4 and fused int8 trees
    splits the same logical axis (d_out, d_in or G) over "model" as the
    JAX package's spec of that leaf, and the spec tree has the params'
    structure."""
    from crisperwhisper_tpu.models import init_params as jinit
    from crisperwhisper_tpu.models import quantize as JQ
    from crisperwhisper_tpu.parallel import param_pspecs as jspecs
    from crisperwhisper_tpu_torch.models import quantize as Q
    from crisperwhisper_tpu_torch.models.whisper import init_params
    from crisperwhisper_tpu_torch.parallel import param_pspecs
    arch = tiny_arch()
    jp = jinit(arch, jax.random.PRNGKey(0))
    tp = init_params(arch, torch.Generator().manual_seed(0))
    jmake = {"plain": lambda p: p,
             "int8": JQ.quantize_decoder_weights,
             "int4": lambda p: JQ.quantize_decoder_weights(p, bits=4),
             "fused": lambda p: JQ.quantize_decoder_weights(
                 JQ.fuse_decoder_qkv(p, arch.head_dim))}[kind]
    tmake = {"plain": lambda p: p,
             "int8": Q.quantize_decoder_weights,
             "int4": lambda p: Q.quantize_decoder_weights(p, bits=4),
             "fused": lambda p: Q.quantize_decoder_weights(
                 Q.fuse_decoder_qkv(p, arch.head_dim))}[kind]
    js, tree = jspecs(jmake(jp)), tmake(tp)
    specs = param_pspecs(tree)
    leaves = list(_walk(tree))
    assert [p for p, _ in _walk(specs)] == [p for p, _ in leaves]
    split = 0
    for path, spec in _walk(specs):
        if "layers" in path:
            jpath = path[:2] + path[3:]             # drop the layer index
            node = js
            for k in jpath:
                node = node[k]
            want = _split_axis(tuple(node), _JAX_AXES[path[-1]]) \
                if path[-1] in _JAX_AXES else None
        else:
            node = js
            for k in path:
                node = node[k]
            assert tuple(node) == ()
            want = None
        got = (_split_axis(spec, _PORT_AXES[path[-1]])
               if path[-1] in _PORT_AXES else None)
        assert got == want, (path, spec, tuple(node))
        split += got is not None
    assert split > 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_greedy_matches_jax(run, world):
    """TP (and, in the world of 4, DP) decode on the mesh: tokens equal to
    the JAX package's unsharded decode, log-probability sums within 1e-4
    (f32 sums), and tokens equal to the port's decode on one rank."""
    for r in _world(run, world):
        got = r["greedy"]
        np.testing.assert_array_equal(np.asarray(got["sequences"]),
                                      run["greedy"].sequences)
        np.testing.assert_allclose(np.asarray(got["sum_logprobs"]),
                                   run["greedy"].sum_logprobs, atol=1e-4)
        assert got["sequences"] == r["greedy_one"]["sequences"]


@pytest.mark.parametrize("world", WORLDS)
def test_tensor_parallel_encoder_matches_unsharded(run, world):
    """Each rank's TP encoder states within 2e-5 of the unsharded encoder
    on the same rows (the JAX two-process test's band), and of the JAX
    package's encoder."""
    _, out = run["worlds"][world]
    for r in _world(run, world):
        enc = np.load(os.path.join(out, f"enc_{r['rank']}.npz"))
        np.testing.assert_allclose(enc["tp"], enc["one"], atol=ENC_BAND,
                                   rtol=ENC_BAND)
        np.testing.assert_allclose(enc["tp"], run["enc"][enc["rows"]],
                                   atol=ENC_BAND, rtol=ENC_BAND)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_int8_decode_matches_unsharded(run, world):
    """int8 weights (unfused) with an int8 cross cache, sharded: tokens
    equal to the port's unsharded quantized decode and to the JAX
    package's."""
    for r in _world(run, world):
        assert r["int8"]["sequences"] == r["int8_one"]["sequences"]
        np.testing.assert_array_equal(np.asarray(r["int8"]["sequences"]),
                                      run["int8"].sequences)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_pipeline_matches_unsharded_and_jax(run, world):
    """load_pipeline(mesh=) served from rank 0 (the others follow): text
    equal to the unsharded port pipeline's with word timestamps within
    1e-4, and to the JAX pipeline's within TS_BAND."""
    r0 = _world(run, world)[0]
    ref, got = r0["pipeline_one"], r0["pipeline"]["direct"][0]
    jref = run["pipeline"]
    assert got["chunks"] and got["text"] == ref["text"] == jref["text"]
    assert [c["text"] for c in got["chunks"]] == \
        [c["text"] for c in ref["chunks"]] == \
        [c["text"] for c in jref["chunks"]]
    for a, b, c in zip(ref["chunks"], got["chunks"], jref["chunks"]):
        np.testing.assert_allclose(b["timestamp"], a["timestamp"], atol=1e-4)
        np.testing.assert_allclose(b["timestamp"], c["timestamp"],
                                   atol=TS_BAND)


@pytest.mark.parametrize("world", WORLDS)
def test_streaming_batcher_over_mesh_pipeline(run, world):
    """Three streams through a StreamingBatcher on rank 0 of the mesh
    pipeline: each equal to the direct call."""
    pipeline = _world(run, world)[0]["pipeline"]
    direct = pipeline["direct"][0]
    assert len(pipeline["streams"]) == 3
    for s in pipeline["streams"]:
        assert s["text"] == direct["text"]
        assert [c["text"] for c in s["chunks"]] == \
            [c["text"] for c in direct["chunks"]]
        for a, b in zip(direct["chunks"], s["chunks"]):
            np.testing.assert_allclose(b["timestamp"], a["timestamp"],
                                       atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["prompt_lookup", "self:1"])
def test_speculative_mesh_pipeline_equals_greedy(run, world, mode):
    """load_pipeline(mesh=, assistant=...): prompt lookup and a one-layer
    self-draft of the sharded tree give the mesh's greedy result."""
    r0 = _world(run, world)[0]
    ref, got = r0["pipeline"]["direct"][0], r0[f"assistant_{mode}"]
    assert got["text"] == ref["text"]
    assert [c["text"] for c in got["chunks"]] == \
        [c["text"] for c in ref["chunks"]]
    for a, b in zip(ref["chunks"], got["chunks"]):
        np.testing.assert_allclose(b["timestamp"], a["timestamp"], atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_sampled_fallback_on_mesh_matches_one_process(run, world):
    """Temperature fallback on the mesh (every window fails the log-prob
    gate until the last temperature, so sampled windows decode): with a
    generator seeded differently on each rank, every rank's generate
    returns the tokens one process draws with rank 0's generator, token
    timestamps within 1e-4, and another seed gives other tokens; the mesh
    pipeline's text equals the unsharded pipeline's under the same
    options, and differs from its greedy text."""
    for r in _world(run, world):
        fb = r["fallback"]
        assert fb["mesh"]["sequences"] == fb["one"]["sequences"]
        assert fb["one"]["sequences"] != fb["other_seed"]["sequences"]
        np.testing.assert_allclose(fb["mesh"]["token_timestamps"],
                                   fb["one"]["token_timestamps"], atol=1e-4)
    r0 = _world(run, world)[0]
    ref, got = r0["fallback"]["pipeline_one"], r0["fallback"]["pipeline"]
    assert got["chunks"] and got["text"] == ref["text"]
    assert got["text"] != r0["pipeline"]["direct"][0]["text"]
    assert [c["text"] for c in got["chunks"]] == \
        [c["text"] for c in ref["chunks"]]
    for a, b in zip(ref["chunks"], got["chunks"]):
        np.testing.assert_allclose(b["timestamp"], a["timestamp"], atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_that_decode_different_tokens_fail_loudly(run, world):
    """The check after each window on a mesh: when the last rank holds
    other tokens, every rank raises RuntimeError."""
    assert all(r["divergence_raises"] for r in _world(run, world))


def test_mesh_batch_size_must_be_a_multiple_of_the_data_axis(run):
    """ASRPipeline on a data axis of 2 with batch_size 5: ValueError
    naming the multiple."""
    assert all(r["multiple"] for r in _world(run, 4))


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_and_serving_mesh_errors(run, world):
    """make_mesh larger than the world, make_serving_mesh with a model
    axis that does not divide a host's ranks or a data axis other than
    the job's, and a load device other than the mesh's, all raise
    ValueError."""
    for r in _world(run, world):
        assert r["needs"] and r["divide"] and r["data_axis"]
        assert r["device_mismatch"]


@pytest.mark.parametrize("world", WORLDS)
def test_serving_mesh_helpers(run, world):
    """make_serving_mesh(model=2): the data axis takes every other rank,
    each model group lies on one host (consecutive ranks under
    LOCAL_WORLD_SIZE=2); process_local_batch divides by the data axis;
    host_local_array has the global shape and sums every rank's rows."""
    data = world // 2
    for r in _world(run, world):
        sm = r["serving_mesh"]
        assert sm["shape"] == [data, 2] and sm["names"] == ["data", "model"]
        first = r["rank"] // 2 * 2
        assert sm["model_group"] == [first, first + 1]
        assert r["local_batch"] == 8 // data
        assert r["host_local"]["shape"] == [2 * data, 8]
        assert r["host_local"]["sum"] == 2 * 8 * sum(range(1, world + 1))


@pytest.mark.parametrize("world", WORLDS)
def test_serving_mesh_runs_sharded_decode(run, world):
    """A decode of 6 tokens over make_serving_mesh(model=2) gives (4, 7)
    sequences, the first 7 columns of the JAX package's decode."""
    for r in _world(run, world):
        seqs = np.asarray(r["serving_mesh_greedy"]["sequences"])
        assert seqs.shape == (4, 7)
        np.testing.assert_array_equal(seqs, run["greedy"].sequences[:, :7])


@pytest.mark.parametrize("world", WORLDS)
def test_shard_params_partitions_the_layer_stacks(run, world):
    """Each rank holds under 0.55 + 0.45 / model of the replicated bytes
    (dryrun_multichip's audit at model = 2)."""
    for r in _world(run, world):
        assert r["param_share"] < 0.55 + 0.45 / 2


def test_decode_step_kernel_gate_refuses_mesh_trees(run):
    """Kernel 5 stays off a mesh: its weight test takes the fused int8
    serving tree on one rank, and refuses load_pipeline(quantize=
    "serving", mesh=)'s tree (q/k/v unfused) and a fused tree sharded over
    the mesh (its row-parallel denses sum over ranks)."""
    for world in WORLDS:
        for r in _world(run, world):
            assert r["gate"] == {"one_rank_fused": True,
                                 "mesh_serving": False, "mesh_fused": False}


def test_dryrun_multichip_on_cpu_ranks(capsys):
    """The twin of __graft_entry__.dryrun_multichip on 4 gloo CPU ranks:
    mesh 1 data x 4 model at base geometry, its partitioning audit, then
    encode, 8 greedy tokens with alignment capture and the jump times."""
    from crisperwhisper_tpu_torch.parallel.dryrun import dryrun_multichip
    line = dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip OK: mesh=(1 data x 4 model), "
                           "batch=2, arch=base(d=512, L=6+6)"), line
    assert line in capsys.readouterr().out


def test_unsharded_tree_takes_no_collective(monkeypatch):
    """Without a process group and with every collective made to fail,
    encode and a greedy decode with alignment capture run on an unsharded
    tree: the unsharded path calls no collective."""
    import torch.distributed as dist
    from crisperwhisper_tpu_torch.config import GenerationOptions
    from crisperwhisper_tpu_torch.decoding.greedy import greedy_decode
    from crisperwhisper_tpu_torch.models.whisper import (alignment_selector,
                                                         encode, init_params)
    assert not dist.is_initialized()

    def refuse(*a, **k):
        raise AssertionError("collective on an unsharded tree")

    for name in ("all_reduce", "all_gather_object", "broadcast_object_list"):
        monkeypatch.setattr(dist, name, refuse)
    arch = tiny_arch()
    params = init_params(arch, torch.Generator().manual_seed(0))
    enc = encode(params, arch, torch.from_numpy(rand_mel(batch=2, seed=1)))
    res = greedy_decode(params, arch, TINY_SPECIALS,
                        GenerationOptions(max_initial_timestamp_index=50),
                        enc, torch.full((2, 1), TINY_SPECIALS.sot),
                        max_new_tokens=4,
                        align_sel=alignment_selector(arch, ((0, 1), (1, 3))))
    assert tuple(res.sequences.shape) == (2, 5)


def test_start_up_without_a_world_or_a_card(monkeypatch):
    """In one process: init_multihost with no arguments is a no-op; NCCL
    without a card is a RuntimeError naming gloo; make_mesh without a
    process group and dryrun_multichip on more cards than exist raise,
    the latter naming device="cpu"."""
    import torch.distributed as dist
    from crisperwhisper_tpu_torch.parallel import init_multihost, make_mesh
    from crisperwhisper_tpu_torch.parallel.dryrun import dryrun_multichip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init_multihost()
    init_multihost(num_processes=1)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match='backend="gloo"'):
        init_multihost("127.0.0.1:1", 2, 0)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_multihost"):
        make_mesh(1, 1, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dryrun_multichip(2)
