"""The packed int4 encode and decode groups of repro_torch against repro
(the JAX reference), on the CPU.

On the card one launch of ``csrc/pow2_packed.cu::p2_enc_packed`` encodes
every TT core of a deploy export (``ckpt.export_tt_deploy``) and one of
``p2_dec_packed`` decodes them on load (``ckpt.load_tt_deploy``). Here,
where no kernel runs, the tests hold what those launches rest on:

(a) the launch plan (``kernels/grouped.py::pk_plan``), a pure function of
    the shapes: the tile prefix, chunks above the cap, 16-byte code and
    value offsets, odd ``last``, the 0-d scalar's (1, 1), an empty list;
(b) the group encode's and decode's plain twins, entry by entry, against
    JAX's reference codec and its Pallas packed kernels in interpret mode:
    the six FMNIST cores at their ``wscale_log2``, a stacked (3, 5, 7) with
    a step per row, an odd ``last``, a non-integer step and a scalar, all
    in one group; the twins' layout (one buffer, zero pads) and
    ``encode_packed`` / ``decode_packed`` as groups of one;
(c) the grouped ``export_tt_deploy``: its file byte for byte equal to the
    per-leaf route's (one codec call a core, the route the groups
    replaced), its arrays equal to JAX's export key by key, loadable in
    JAX, and ``load_tt_deploy`` equal to the per-core decode, for the
    FMNIST MLP and for stacked cores with a step per stacked core.

Inputs are made with numpy from a seed and handed to both packages; the
params start from JAX's ``init_mlp`` and cross by ``mlp_params_from_jax``.
Tolerance: none, everything here is bit-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

import repro.ckpt.checkpoint as JCK  # noqa: E402
from repro import numerics as JN  # noqa: E402
from repro.models import mlp_tt as JM  # noqa: E402
from repro_torch import ckpt as TCK  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.ckpt import checkpoint as TCKM  # noqa: E402
from repro_torch.convert import mlp_params_from_jax  # noqa: E402
from repro_torch.kernels import grouped as G  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402

JSPEC = JN.QuantSpec("pow2", 4, 0, "int4x2", "fixed")
TSPEC = TN.QuantSpec("pow2", 4, 0, "int4x2", "fixed")


def _params():
    jp = JM.init_mlp(jax.random.PRNGKey(0), JM.make_mlp())
    return jp, mlp_params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")


# ---------------------------------------------------------------------------
# (a) the launch plan
# ---------------------------------------------------------------------------

def test_pk_plan_of_the_export_cores():
    """The FMNIST export's six cores, each one row: one launch, a tile
    each, codes and values back to back (every size is on 16 bytes)."""
    sizes = [448, 4096, 1024, 4096, 512, 4096]
    (launch,) = G.pk_plan([(1, n) for n in sizes])
    assert list(launch.index) == list(range(6))
    assert launch.tile_end == (1, 2, 3, 4, 5, 6)
    assert [lf.code_off for lf in launch.leaves] == [
        0, 224, 2272, 2784, 4832, 5088]
    assert [lf.out_off for lf in launch.leaves] == [
        0, 448, 4544, 5568, 9664, 10176]
    assert launch.codes == 7136 and launch.out == 14272


def test_pk_plan_odd_last_scalar_many_tiles_and_empty():
    plan = G.pk_plan([(3, 7), (1, 1), (1, 2 * G.PK_TILE + 2), (0, 5),
                      (2, 0), (5, 13)])
    (launch,) = plan
    assert [(lf.rows, lf.last, lf.pk, lf.nbytes, lf.tiles)
            for lf in launch.leaves] == [
        (3, 7, 4, 12, 1), (1, 1, 1, 1, 1), (1, 2 * G.PK_TILE + 2,
                                            G.PK_TILE + 1, G.PK_TILE + 1, 2),
        (0, 5, 3, 0, 0), (2, 0, 0, 0, 0), (5, 13, 7, 35, 1)]
    assert launch.tile_end == (1, 2, 4, 4, 4, 5)
    assert [lf.code_off for lf in launch.leaves] == [
        0, 16, 32, 32 + 2064, 32 + 2064, 32 + 2064]
    assert [lf.out_off for lf in launch.leaves] == [
        0, 24, 28, 28 + 4100, 28 + 4100, 28 + 4100]
    assert launch.codes == 32 + 2064 + 48
    assert launch.out == 28 + 4100 + 68
    assert G.pk_plan([]) == []


def test_pk_plan_chunks_above_the_cap():
    rng = np.random.RandomState(3)
    shapes = [(int(rng.randint(0, 5)), int(rng.randint(0, 3000)))
              for _ in range(2 * G.PK_CAP + 1)]
    plan = G.pk_plan(shapes)
    assert [list(p.index) for p in plan] == [
        list(range(G.PK_CAP)), list(range(G.PK_CAP, 2 * G.PK_CAP)),
        [2 * G.PK_CAP]]
    for launch in plan:
        ends = code_end = out_end = 0
        for leaf, end, i in zip(launch.leaves, launch.tile_end,
                                launch.index):
            rows, last = shapes[i]
            assert (leaf.rows, leaf.last) == (rows, last)
            assert leaf.nbytes == rows * -(-last // 2)
            assert end - ends == -(-leaf.nbytes // G.PK_TILE)
            ends = end
            assert leaf.code_off % 16 == 0 and leaf.out_off % 4 == 0
            assert leaf.code_off >= code_end and leaf.out_off >= out_end
            assert leaf.code_off - code_end < 16
            assert leaf.out_off - out_end < 4
            code_end = leaf.code_off + leaf.nbytes
            out_end = leaf.out_off + leaf.numel
        assert 0 <= launch.codes - code_end < 16
        assert 0 <= launch.out - out_end < 4
        assert launch.tiles == ends


# ---------------------------------------------------------------------------
# (b) the twins against JAX
# ---------------------------------------------------------------------------

def _cases():
    """(name, x, step) with x of any rank and a step JAX's codec takes: the
    six cores flattened at their wscale_log2, a stacked tensor with a step
    per row, an odd last under one step, a non-integer step, a scalar."""
    jp, _ = _params()
    out = []
    for layer in ("l1", "l2"):
        for n in range(4 if layer == "l1" else 2):
            out.append((f"{layer}/core_{n}",
                        np.asarray(jp[layer][f"core_{n}"]).reshape(-1),
                        np.float32(np.asarray(jp[layer]["wscale_log2"])[n])))
    rng = np.random.RandomState(11)
    out.append(("stacked per-row", np.asarray(
        rng.standard_normal((3, 5, 7)) * .3, np.float32),
        np.asarray([-3, -2, -4], np.float32)))
    out.append(("odd last", np.asarray(rng.standard_normal((5, 13)),
                                       np.float32), np.float32(-2)))
    out.append(("non-integer step", np.asarray(
        rng.standard_normal((4, 32)), np.float32), np.float32(-2.5)))
    out.append(("scalar", np.asarray(0.7, np.float32), np.float32(-2)))
    return out


def _group_inputs(cases):
    x2ds, srows, lasts = [], [], []
    for _, x, s in cases:
        x2d, srow = CB._rowwise_lastdim(torch.from_numpy(np.array(x)),
                                        torch.from_numpy(np.array(s)))
        x2ds.append(x2d)
        srows.append(srow)
        lasts.append(x2d.shape[1])
    return x2ds, srows, lasts


def test_group_twins_bit_identical_to_jax_leaf_by_leaf(monkeypatch):
    """One group of every case: each entry's bytes equal JAX's reference
    and Pallas (interpret) encode, each entry's values JAX's decodes."""
    monkeypatch.setenv("JAX_PALLAS_INTERPRET", "1")
    cases = _cases()
    x2ds, srows, lasts = _group_inputs(cases)
    codes = CB.encode_packed_many(x2ds, srows, 4)
    ys = CB.decode_packed_many(codes, srows, lasts)
    assert len({c.untyped_storage().data_ptr() for c in codes}) == 1
    assert len({y.untyped_storage().data_ptr() for y in ys}) == 1
    for (name, x, s), c, y, x2d in zip(cases, codes, ys, x2ds):
        jq = JN.encode(jnp.asarray(x), JSPEC, jnp.asarray(s))
        pq = JN.encode(jnp.asarray(x), JSPEC, jnp.asarray(s),
                       backend="pallas")
        want = np.asarray(jq.codes).reshape(c.shape)
        np.testing.assert_array_equal(c.numpy(), want, err_msg=name)
        np.testing.assert_array_equal(
            c.numpy(), np.asarray(pq.codes).reshape(c.shape), err_msg=name)
        jd = np.asarray(JN.decode(jq)).reshape(y.shape)
        np.testing.assert_array_equal(y.numpy(), jd, err_msg=name)
        np.testing.assert_array_equal(
            y.numpy(), np.asarray(JN.decode(pq, backend="pallas")).reshape(
                y.shape), err_msg=name)
        assert tuple(y.shape) == tuple(x2d.shape)


def test_group_twins_lay_out_one_buffer_with_zero_pads():
    cases = _cases()
    x2ds, srows, lasts = _group_inputs(cases)
    codes = CB.encode_packed_many(x2ds, srows, 4)
    ys = CB.decode_packed_many(codes, srows, lasts)
    (launch,) = G.pk_plan([tuple(x.shape) for x in x2ds])
    flat = torch.empty(0, dtype=torch.int8).set_(codes[0].untyped_storage())
    vals = torch.empty(0).set_(ys[0].untyped_storage())
    assert flat.numel() == launch.codes and vals.numel() == launch.out
    used = torch.zeros(launch.codes, dtype=torch.bool)
    vused = torch.zeros(launch.out, dtype=torch.bool)
    for c, y, leaf in zip(codes, ys, launch.leaves):
        assert c.storage_offset() == leaf.code_off and c.is_contiguous()
        assert y.storage_offset() == leaf.out_off and y.is_contiguous()
        used[leaf.code_off:leaf.code_off + leaf.nbytes] = True
        vused[leaf.out_off:leaf.out_off + leaf.numel] = True
    assert not flat[~used].any() and not vals[~vused].any()
    # odd last: each row's last byte has a zero high nibble
    odd = codes[[n for n, _, _ in cases].index("odd last")]
    assert not (odd[:, -1].to(torch.int32) & 0xF0).any()


def test_single_codec_calls_are_groups_of_one():
    cases = _cases()
    x2ds, srows, lasts = _group_inputs(cases)
    codes = CB.encode_packed_many(x2ds, srows, 4)
    for x2d, srow, last, c in zip(x2ds, srows, lasts, codes):
        one = CB.encode_packed(x2d, srow, 4)
        assert torch.equal(one, c)
        assert torch.equal(one, CB.encode_packed_plain(x2d, srow, 4))
        assert torch.equal(CB.decode_packed(one, srow, last),
                           CB.decode_packed_plain(one, srow, last))


def test_group_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(2, 7)
    with pytest.raises(ValueError, match="scales"):
        CB.encode_packed_many([x, x], [torch.zeros(2)], 4)
    with pytest.raises(ValueError, match="rows, last"):
        CB.encode_packed_many([torch.zeros(7)], [torch.zeros(1)], 4)
    with pytest.raises(ValueError):
        CB.encode_packed_many([x], [torch.zeros(3)], 4)
    with pytest.raises(ValueError, match="bytes for last=7"):
        CB.decode_packed_many([torch.zeros((2, 3), dtype=torch.int8)],
                              [torch.zeros(2)], [7])
    with pytest.raises(ValueError, match="lengths"):
        CB.decode_packed_many([torch.zeros((2, 4), dtype=torch.int8)],
                              [torch.zeros(2)], [7, 7])
    assert CB.encode_packed_many([], [], 4) == []
    assert CB.decode_packed_many([], [], []) == []


# ---------------------------------------------------------------------------
# (c) the export and the load
# ---------------------------------------------------------------------------

def _per_leaf_export(path, params, policy=None):
    """The route the groups replaced: one codec call a core, one copy to
    the host a core's codes and one its step."""
    spec = (policy or TN.NumericsPolicy(enable=True)).spec_for("tt_factor")
    spec = dataclasses.replace(spec, storage_dtype="int4x2")
    arrays, deploy_meta, sizes = {}, {}, [0, 0]

    def visit(tree, prefix):
        steps = tree.get("wscale_log2")
        for k, v in tree.items():
            key = f"{prefix}§{k}" if prefix else k
            if isinstance(v, dict):
                visit(v, key)
            elif k.startswith("core_") and steps is not None:
                scale = steps[..., int(k.split("_")[1])].float()
                qt = TN.encode(v.reshape(tuple(v.shape[:-4]) + (-1,)), spec,
                               scale, backend="cuda")
                arrays[key + "§q"] = qt.codes.detach().cpu()
                arrays[key + "§scale"] = scale.detach().cpu()
                deploy_meta[key] = {"spec": spec.to_json_dict(),
                                    "shape": list(v.shape)}
                sizes[0] += qt.nbytes()
                sizes[1] += v.numel() * 4
            else:
                arrays.update(TCKM._flatten(v, key))

    visit(params, "")
    stats = {"packed_bytes": sizes[0], "fp32_bytes": sizes[1],
             "reduction_x": sizes[1] / max(sizes[0], 1)}
    with open(path, "wb") as f:
        f.write(TCKM._encode(arrays, {
            "format": "tt_deploy", "tt_deploy": deploy_meta,
            "stats": stats}))
    return stats


def _stacked_params():
    """Two stacked blocks of three TT cores each, a step per stacked core
    (odd flattened sizes among them), beside a bias."""
    rng = np.random.RandomState(21)
    blk = {f"core_{n}": np.asarray(rng.standard_normal(shape) * .2,
                                   np.float32)
           for n, shape in enumerate([(3, 1, 3, 5, 2), (3, 2, 4, 4, 2),
                                      (3, 2, 7, 1, 1)])}
    blk["wscale_log2"] = np.asarray(rng.randint(-5, -1, (3, 3)), np.float32)
    blk["bias"] = np.asarray(rng.standard_normal(9), np.float32)
    jp = {"blk": {k: jnp.asarray(v) for k, v in blk.items()}}
    tp = {"blk": {k: torch.from_numpy(v.copy()) for k, v in blk.items()}}
    return jp, tp


def _trees():
    jp, tp = _params()
    sjp, stp = _stacked_params()
    return [("fmnist", jp, tp), ("stacked", sjp, stp)]


@pytest.mark.parametrize("which", ["fmnist", "stacked"])
def test_grouped_export_file_equals_the_per_leaf_route(which, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(JCK, "zstandard", None)
    _, jp, tp = dict((t[0], t) for t in _trees())[which]
    gpath, lpath, jpath = (str(tmp_path / n) for n in ("g", "l", "j"))
    stats = TCK.export_tt_deploy(gpath, tp)
    assert stats == _per_leaf_export(lpath, tp)
    with open(gpath, "rb") as f, open(lpath, "rb") as g:
        assert f.read() == g.read()
    assert stats == JCK.export_tt_deploy(jpath, jp)
    if which == "fmnist":
        assert stats["packed_bytes"] == 7160
        assert round(stats["reduction_x"], 2) == 7.97
    # the same arrays as JAX's file, key by key (the trees' key orders
    # differ, so the files' bytes do)
    with open(gpath, "rb") as f, open(jpath, "rb") as g:
        mine, theirs = msgpack.unpackb(f.read()), msgpack.unpackb(g.read())
    assert mine["meta"] == theirs["meta"]
    assert mine["arrays"] == theirs["arrays"]


@pytest.mark.parametrize("which", ["fmnist", "stacked"])
def test_grouped_load_equals_the_per_core_decode_and_jax(which, tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(JCK, "zstandard", None)
    _, jp, tp = dict((t[0], t) for t in _trees())[which]
    path = str(tmp_path / "d")
    TCK.export_tt_deploy(path, tp)
    back, meta = TCK.load_tt_deploy(path, device="cpu")
    packed, _ = TCK.load_tt_deploy(path, dequantize=False, device="cpu")
    jback, jmeta = JCK.load_tt_deploy(path)
    assert meta == jmeta
    for layer, tree in tp.items():
        if not isinstance(tree, dict):
            continue                         # the ActQuant sites
        assert list(back[layer]) == list(packed[layer])
        for k, v in tree.items():
            if not k.startswith("core_"):
                assert torch.equal(back[layer][k], v)
                continue
            qt = packed[layer][k]
            assert isinstance(qt, TN.QTensor)
            want = TN.decode(qt, backend="cuda").reshape(v.shape)
            got = back[layer][k]
            assert tuple(got.shape) == tuple(v.shape)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jback[layer][k]))
            step = tree["wscale_log2"][..., int(k.split("_")[1])].float()
            rt = TN.roundtrip(v.reshape(tuple(v.shape[:-4]) + (-1,)),
                              TSPEC, step).reshape(v.shape)
            assert torch.equal(got, rt)
