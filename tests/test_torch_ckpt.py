"""repro_torch.ckpt against repro.ckpt (the JAX reference): the container
format, the port's own msgpack subset and the packed-int4 TT deploy
export.

- The port's msgpack bytes equal ``msgpack.packb(obj, use_bin_type=True)``
  for every type the container uses, at every length boundary of the
  format, and it reads what ``msgpack`` writes.
- A deploy file written by either package loads in the other with
  identical cores (bit for bit) and identical stats; so does a checkpoint
  of the params and of an int8 Adam state.
- ``repro`` compresses with zstd where its ``zstandard`` module is
  present; the port writes and reads raw msgpack, so the cross-package
  files here are written by ``repro`` with zstd switched off, and a zstd
  file makes the port raise.

All comparisons are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

import repro.ckpt.checkpoint as JCK  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.models import mlp_tt as JM  # noqa: E402
from repro.optim import adam as JA  # noqa: E402
from repro_torch import ckpt as TCK  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.ckpt import _msgpack  # noqa: E402
from repro_torch.ckpt import checkpoint as TCKM  # noqa: E402
from repro_torch.convert import (adam_state_from_jax,  # noqa: E402
                                 mlp_params_from_jax)
from repro_torch.tree import flatten_with_path  # noqa: E402

_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
         2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
         -2 ** 31 - 1, -2 ** 63]
_OBJS = [None, True, False, 1.5, -0.0, 3.1e300, 7.973184357541899,
         "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 70000, "§q é",
         b"", b"x" * 255, b"y" * 256, b"z" * 70000, list(range(15)),
         list(range(16)), list(range(70000)), (1, 2),
         {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
         {"meta": {"n": [1, 2.0, "x", b"b", None, {"k": False}]}}] + _INTS


@pytest.mark.parametrize("obj", _OBJS, ids=lambda o: repr(o)[:24])
def test_msgpack_bytes_equal_msgpack_packb(obj):
    raw = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == raw
    assert _msgpack.unpackb(raw) == msgpack.unpackb(raw, raw=False,
                                                    strict_map_key=False)


def test_msgpack_refuses_what_the_container_does_not_use():
    with pytest.raises(TypeError):
        _msgpack.packb({1, 2})
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb([1, 2])[:-1])


def _params():
    d = JM.make_mlp()
    jp = JM.init_mlp(jax.random.PRNGKey(0), d)
    return d, jp, mlp_params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _raw_jax(monkeypatch):
    monkeypatch.setattr(JCK, "zstandard", None)


def test_container_payload_bytes_equal_jax():
    _, jp, tp = _params()
    jarr = JCK._flatten(jp)
    tarr = TCKM._flatten(tp)
    assert list(jarr) == sorted(jarr) and sorted(jarr) == sorted(tarr)
    tarr = {k: tarr[k] for k in jarr}           # JAX's key order
    meta = {"step": 3, "note": "x"}
    assert TCKM._encode(tarr, meta) == msgpack.packb(
        {"meta": meta, "arrays": {k: {"dtype": str(v.dtype),
                                      "shape": list(v.shape),
                                      "data": v.tobytes()}
                                  for k, v in jarr.items()}},
        use_bin_type=True)


def test_deploy_export_loads_across_packages(tmp_path, monkeypatch):
    """JAX's file in the port and the port's in JAX: identical cores
    (dequantized and packed), stats and non-core leaves."""
    _raw_jax(monkeypatch)
    _, jp, tp = _params()
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jstats = JCK.export_tt_deploy(jpath, jp)
    tstats = TCK.export_tt_deploy(tpath, tp)
    assert tstats == jstats
    assert tstats["packed_bytes"] == 7160
    assert round(tstats["reduction_x"], 2) == 7.97
    j_of_t, jmeta = JCK.load_tt_deploy(tpath)
    t_of_j, tmeta = TCK.load_tt_deploy(jpath, device="cpu")
    t_of_t, _ = TCK.load_tt_deploy(tpath, device="cpu")
    assert tmeta == jmeta
    for layer in ("l1", "l2"):
        for k, v in j_of_t[layer].items():
            np.testing.assert_array_equal(t_of_j[layer][k].numpy(),
                                          np.asarray(v), err_msg=k)
            np.testing.assert_array_equal(t_of_t[layer][k].numpy(),
                                          np.asarray(v), err_msg=k)
        for n in range(2 if layer == "l2" else 4):
            core = t_of_t[layer][f"core_{n}"]
            assert tuple(core.shape) == tuple(jp[layer][f"core_{n}"].shape)
            assert core.unique().numel() <= 16       # a 4-bit grid
    assert set(t_of_j["q_in"]) == {".act", ".grad", ".probe"}
    # packed containers: the same bytes either way
    jq, _ = JCK.load_tt_deploy(tpath, dequantize=False)
    tq, _ = TCK.load_tt_deploy(jpath, dequantize=False, device="cpu")
    for layer in ("l1", "l2"):
        for k, qt in jq[layer].items():
            if k.startswith("core_"):
                assert isinstance(tq[layer][k], TN.QTensor)
                np.testing.assert_array_equal(tq[layer][k].codes.numpy(),
                                              np.asarray(qt.codes))
                assert tq[layer][k].nbytes() == qt.nbytes()


def test_deploy_cores_equal_encode_decode_of_params(tmp_path):
    d, _, tp = _params()
    path = str(tmp_path / "d.ckpt")
    TCK.export_tt_deploy(path, tp)
    back, meta = TCK.load_tt_deploy(path, device="cpu")
    assert meta["format"] == "tt_deploy"
    spec = TN.QuantSpec("pow2", 4, 0, "int4x2", "fixed")
    for layer in ("l1", "l2"):
        for n in range(2 if layer == "l2" else 4):
            core = tp[layer][f"core_{n}"]
            step = tp[layer]["wscale_log2"][n].float()
            want = TN.roundtrip(core.reshape(-1), spec, step).reshape(
                core.shape)
            assert torch.equal(back[layer][f"core_{n}"], want)


def test_zstd_checkpoint_raises(tmp_path):
    pytest.importorskip("zstandard")
    _, jp, _ = _params()
    path = str(tmp_path / "z.ckpt")
    JCK.export_tt_deploy(path, jp)
    with pytest.raises(RuntimeError, match="zstd"):
        TCK.load_tt_deploy(path, device="cpu")


def test_save_load_params_and_int8_moments_across_packages(tmp_path,
                                                           monkeypatch):
    _raw_jax(monkeypatch)
    _, jp, tp = _params()
    jst = JA.init_adam(jp, JTrainConfig(opt_state_dtype="int8"))
    rng = np.random.RandomState(0)
    jst = jst._replace(m=tuple(
        None if m is None else type(m)(
            jnp.asarray(rng.randint(-127, 128, m.codes.shape), jnp.int8),
            jnp.asarray(rng.random_sample(m.scale.shape), jnp.float32),
            m.spec, m.shape) for m in jst.m))
    tst = adam_state_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    tree_j, tree_t = {"params": jp, "opt": jst}, {"params": tp, "opt": tst}
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    JCK.save(jpath, tree_j, {"step": 7})
    TCK.save(tpath, tree_t, {"step": 7})
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    # the port restores JAX's file into its own structure
    back, meta = TCK.load(jpath, like=tree_t)
    assert meta == {"step": 7}
    for (p, a), (_, b) in zip(flatten_with_path(back["params"]),
                              flatten_with_path(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    for a, b in zip(back["opt"].m, tst.m):
        assert (a is None) == (b is None)
        if b is not None:
            assert isinstance(a, TN.QTensor) and a.spec == b.spec
            assert torch.equal(a.codes, b.codes)
            assert torch.equal(a.scale, b.scale)
    # and JAX reads the port's
    jback, _ = JCK.load(tpath, like=tree_j)
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(tree_j)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(KeyError):
        TCK.load(tpath, like={"missing": torch.zeros(2)})
