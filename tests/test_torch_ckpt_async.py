"""repro_torch's launch and checkpoint tooling against repro (the JAX
reference): the asynchronous checkpointer, its step files and garbage
collection, the streamed container, the prefetcher and the host shard,
the parameter and model-FLOPs counts, and the example twins. All on the
CPU, all comparisons exact.

- ``AsyncCheckpointer`` and its GC behave as ``tests/test_ckpt.py``
  expects of the reference; its snapshot is taken on the caller's thread
  (a later in-place write to the source does not reach the file); its
  writer's exception comes back from ``wait``.
- The streamed file is byte for byte the ``msgpack`` package's document
  of the same arrays and meta, and the reference's raw file for the same tree (``repro`` writes zstd where its
  ``zstandard`` module is present: patched to None here), a zoo LM's
  TrainState in the reference's layout (``steps.stack_state``) included.
- ``load`` reads each array as a view into the one buffer of the file,
  and refuses an array whose shape is not its ``like`` leaf's.
- ``Prefetcher`` orders steps as ``tests/test_data.py`` expects of the
  reference; ``host_shard_info`` is (0, 1) without a process group, and
  ``make_batch_fn`` takes its shard from it.
- ``dryrun.count_params`` / ``active_params`` and
  ``roofline.model_flops_estimate`` equal the reference's for every zoo
  config at its reduced size and at full size for internlm2-1.8b,
  moonshot-v1-16b and deepseek-v2-236b (the port counts meta tensors, the
  reference ``jax.eval_shape`` of its init).
- The example twins run on the CPU at a tiny size.
"""
import os
import shutil
import signal
from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.ckpt.checkpoint as JCK  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import Prefetcher as JPrefetcher  # noqa: E402
from repro.data import lm_batch as j_lm_batch  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import data as TD  # noqa: E402
from repro_torch.ckpt import checkpoint as TCK  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import lm_train_state_from_jax  # noqa: E402
from repro_torch.launch import dryrun as TDR  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402

from test_torch_lm_train import _configs  # noqa: E402


def _dryrun():
    """The reference's ``launch/dryrun.py``: its import asks XLA for 512
    host devices through ``XLA_FLAGS``; the backend is up before it here
    and the variable is put back, so nothing else sees it."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


def _tree():
    g = torch.Generator().manual_seed(0)
    wide = torch.randn((6, 8), generator=g)
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.int32),
                       "c": (torch.zeros((2, 2)), torch.full((3,), 2.5))},
            "bf": torch.randn((4, 3), generator=g).to(torch.bfloat16),
            "codes": torch.randint(-127, 128, (7,), generator=g,
                                   dtype=torch.int8),
            "scalar": torch.tensor(3, dtype=torch.int32),
            "empty": torch.zeros((0, 4)),
            "strided": wide[:, ::2]}


def _jax_tree(tree):
    """The same tree as numpy arrays (bf16 through ml_dtypes)."""
    def conv(t):
        if t.dtype == torch.bfloat16:
            return np.asarray(t.view(torch.int16).numpy()).view(
                jax.numpy.bfloat16)
        return t.contiguous().numpy()
    return jax.tree.map(conv, tree)


def test_async_checkpointer_and_gc(tmp_path):
    ck = TCK.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (10, 20, 30, 40):
        ck.save(step, {"w": torch.full((4,), float(step))})
    ck.wait()
    ck.close()
    assert TCK.latest_step(str(tmp_path)) == 40
    steps = sorted(int(f.split("_")[1].split(".")[0])
                   for f in os.listdir(tmp_path) if f.endswith(".ckpt"))
    assert steps == [30, 40]    # GC kept last 2
    back, meta = TCK.load(TCK.step_path(str(tmp_path), 40),
                          like={"w": torch.zeros((4,))})
    assert meta["step"] == 40
    assert torch.equal(back["w"], torch.full((4,), 40.0))
    assert TCK.step_path("d", 7) == JCK.step_path("d", 7)
    for d in (tmp_path, tmp_path / "none"):
        assert TCK.latest_step(str(d)) == JCK.latest_step(str(d))


def test_snapshot_is_taken_on_the_callers_thread(tmp_path):
    src = torch.arange(6, dtype=torch.float32)
    ck = TCK.AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"w": src, "s": TCK.Stacked([src, src + 1])})
    src.add_(100.0)                         # after save returned
    ck.wait()
    ck.close()
    back, meta = TCK.load(TCK.step_path(str(tmp_path), 1))
    assert torch.equal(back["w"], torch.arange(6, dtype=torch.float32))
    assert torch.equal(back["s"], torch.stack([back["w"], back["w"] + 1]))
    assert meta == {"step": 1}


def test_writer_exception_comes_back_from_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    ck = TCK.AsyncCheckpointer(str(blocker / "sub"))
    ck.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.close()


def test_streamed_file_is_the_encoded_document(tmp_path):
    tree, meta = _tree(), {"loss": 1.5, "final": True, "note": "x"}
    arrays = {k: v.contiguous() for k, v in TCK._flatten(tree).items()}
    want = msgpack.packb({"meta": dict(meta, step=3), "arrays": {
        k: {"dtype": str(v.dtype).removeprefix("torch."),
            "shape": list(v.shape),
            "data": (v.view(torch.int16) if v.dtype == torch.bfloat16
                     else v).numpy().tobytes()}
        for k, v in arrays.items()}}, use_bin_type=True)
    assert TCK._encode(TCK._flatten(tree), dict(meta, step=3)) == want
    path = str(tmp_path / "s.ckpt")
    TCK.save(path, tree, dict(meta, step=3))
    assert Path(path).read_bytes() == want
    ck = TCK.AsyncCheckpointer(str(tmp_path / "a"))
    ck.save(3, tree, meta)
    ck.wait()
    ck.close()
    assert Path(TCK.step_path(str(tmp_path / "a"), 3)).read_bytes() == want


def test_streamed_file_is_the_reference_raw_file(tmp_path, monkeypatch):
    monkeypatch.setattr(JCK, "zstandard", None)
    tree = _tree()
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    JCK.save(jpath, _jax_tree(tree), {"step": 5})
    TCK.save(tpath, tree, {"step": 5})
    assert Path(jpath).read_bytes() == Path(tpath).read_bytes()
    back, _ = JCK.load(tpath)
    assert np.array_equal(back["strided"], tree["strided"].numpy())


@pytest.mark.parametrize("opt", ["float32", "int8"])
def test_train_state_file_is_the_reference_file(tmp_path, monkeypatch,
                                                opt):
    """A zoo LM's TrainState (per-layer in the port, stacked in the
    reference) writes the reference's bytes through ``stack_state`` and
    comes back through ``load_state`` bit for bit."""
    monkeypatch.setattr(JCK, "zstandard", None)
    jcfg, tcfg = _configs()
    jlm = JL.build_lm(jcfg)
    jp = JL.init_lm(jax.random.PRNGKey(0), jlm)
    jt = JTrainConfig(grad_compress=True, opt_state_dtype=opt)
    js = JS.init_train_state(jp, jt, policy=jcfg.quant.policy())
    rng = np.random.default_rng(1)
    js = jax.tree.map(lambda a: (rng.normal(size=a.shape).astype(a.dtype)
                                 if np.issubdtype(a.dtype, np.floating)
                                 else rng.integers(-100, 100, a.shape)
                                 .astype(a.dtype)),
                      jax.tree.map(np.asarray, js))
    ts = lm_train_state_from_jax(js, device="cpu")
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    JCK.save(jpath, js, {"step": 2})
    TCK.save(tpath, TS.stack_state(ts), {"step": 2})
    assert Path(jpath).read_bytes() == Path(tpath).read_bytes()
    like = TS.init_train_state(
        TL.init_lm(torch.Generator().manual_seed(5), TL.build_lm(tcfg),
                   device="cpu"),
        TrainConfig(grad_compress=True, opt_state_dtype=opt),
        policy=tcfg.quant.policy())
    back, meta = TS.load_state(jpath, like)
    assert meta == {"step": 2}
    fa, fb = TCK._flatten(back), TCK._flatten(ts)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_load_reads_arrays_as_views_of_one_buffer(tmp_path):
    path = str(tmp_path / "v.ckpt")
    TCK.save(path, {"a": torch.ones(1000), "b": torch.zeros(1000)})
    arrays, _ = TCK.load(path)
    size = os.path.getsize(path)
    pa, pb = arrays["a"].data_ptr(), arrays["b"].data_ptr()
    assert 0 < abs(pa - pb) < size
    assert torch.equal(arrays["a"], torch.ones(1000))


@pytest.mark.parametrize("like", [
    {"w": torch.zeros(3)},
    {"w": torch.zeros((1, 4))},
    {"w": TCK.Stacked([torch.zeros(4)])},
    {"w": TCK.Stacked([torch.zeros(2)] * 2)},
], ids=["short", "rank", "stacked-rows", "stacked-width"])
def test_load_refuses_a_shape_that_is_not_like(tmp_path, like):
    path = str(tmp_path / "s.ckpt")
    TCK.save(path, {"w": torch.ones((2, 4))})
    ok, _ = TCK.load(path, like={"w": TCK.Stacked([torch.zeros(4)] * 2)})
    assert torch.equal(ok["w"], torch.ones((2, 4)))
    with pytest.raises(ValueError, match="shape"):
        TCK.load(path, like=like)


def test_preemption_handler_flushes_then_exits_143():
    seen = []
    previous = TCK.install_preemption_handler(lambda: seen.append(1))
    try:
        handler = signal.getsignal(signal.SIGTERM)
        with pytest.raises(SystemExit) as e:
            handler(signal.SIGTERM, None)
        assert e.value.code == 143 and seen == [1]
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_prefetcher_orders_steps():
    for cls in (TD.Prefetcher, JPrefetcher):
        fetched = []
        pf = cls(lambda s: {"step": s}, start_step=5, depth=2)
        for step, batch in pf:
            assert batch == {"step": step}
            fetched.append(step)
            if len(fetched) >= 4:
                break
        pf.close()
        assert fetched == [5, 6, 7, 8]


def test_prefetcher_raises_what_make_batch_raised():
    def make(step):
        if step == 2:
            raise ValueError("bad batch")
        return step
    pf = TD.Prefetcher(make, start_step=0)
    got = []
    with pytest.raises(ValueError, match="bad batch"):
        for step, b in pf:
            got.append(b)
    pf.close()
    assert got == [0, 1]


def test_host_shard_info_and_the_batch_shard(monkeypatch):
    assert TD.host_shard_info() == (0, 1)
    _, tcfg = _configs()
    got = TT.make_batch_fn(tcfg, 8, 16, 3)(2)
    want = j_lm_batch(2, batch=8, seq=16, vocab=64, seed=3)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    assert TD.host_shard_info() == (1, 4)
    got = TT.make_batch_fn(tcfg, 8, 16, 3)(2)
    want = j_lm_batch(2, batch=8, seq=16, vocab=64, shard=1, num_shards=4,
                      seed=3)
    assert got["tokens"].shape == (2, 16)
    assert all(np.array_equal(got[k], want[k]) for k in want)


_COUNT_CELLS = [(a, True) for a in TC.ARCHS] + [
    (a, False) for a in ("internlm2-1.8b", "moonshot-v1-16b",
                         "deepseek-v2-236b")]


@pytest.mark.parametrize("arch,reduced", _COUNT_CELLS,
                         ids=[f"{a}-{'reduced' if r else 'full'}"
                              for a, r in _COUNT_CELLS])
def test_param_counts_and_model_flops_equal_jax(arch, reduced):
    jd = _dryrun()
    jcfg = JC.get_reduced(arch) if reduced else JC.get_config(arch)
    tcfg = TC.get_reduced(arch) if reduced else TC.get_config(arch)
    jn = jd.count_params(JSP.params_shapes(JL.build_lm(jcfg)))
    tn = TDR.count_params(TDR.meta_params(tcfg))
    assert tn == jn
    ja, ta = jd.active_params(jcfg, jn), TDR.active_params(tcfg, tn)
    assert ta == ja
    for name, shape in TC.SHAPES.items():
        jshape = JC.SHAPES[name]
        for kind in ("train", "prefill", "decode"):
            assert TR.model_flops_estimate(tcfg, shape, ta, kind) == \
                JR.model_flops_estimate(jcfg, jshape, ja, kind)


def test_card_peaks_are_the_h100s():
    assert (TR.PEAK_FLOPS_BF16, TR.PEAK_FLOPS_FP32, TR.HBM_BW) == \
        (989e12, 67e12, 3.35e12)


def test_quickstart_twin_runs_on_the_cpu(capsys):
    from repro_torch.examples import quickstart
    quickstart.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "TT params: 5,568" in out and "effective ranks" in out


def test_train_lm_100m_twin_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import train_lm_100m
    try:
        state, losses = train_lm_100m.main([
            "--steps", "1", "--batch", "1", "--seq", "8", "--tt", "--device",
            "cpu", "--ckpt-dir", str(tmp_path / "ckpt")])
        assert os.listdir(tmp_path / "ckpt") == ["step_1.ckpt"]
    finally:          # the final save holds lm100m's dense embedding
        shutil.rmtree(tmp_path / "ckpt", ignore_errors=True)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert "[train] step 0 loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-1.6b"])
def test_serve_decode_twin_runs_on_the_cpu(arch, capsys):
    from repro_torch.examples import serve_decode
    s = serve_decode.main(["--arch", arch, "--requests", "2", "--slots",
                           "2", "--prompt-len", "6", "--gen-len", "3",
                           "--quantized", "--device", "cpu"])
    assert s["requests_completed"] == 2 and s["generated_tokens"] == 6
    assert "served 2 requests" in capsys.readouterr().out
