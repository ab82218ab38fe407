"""The grouped fake-quant and blockwise encode and decode launches of
repro_torch against repro (the JAX reference), on the CPU.

On the card one launch of ``csrc/pow2_fq.cu::p2_fq_group`` quantizes a
layer's TT cores, one of ``csrc/blockwise.cu::bw_enc_group`` encodes the
step's moments or its wire leaves and one of ``bw_dec_group`` decodes
them. Here, where no kernel runs, the tests hold what the card's launches
rest on:

(a) the launch plans (``kernels/grouped.py``), pure functions of the
    shapes: chunking above the cap, 16-byte code offsets, the task prefix
    of leaves with blocks of at most and of more than 32 in one group, 0-d
    and one-element leaves, an empty list;
(b) the group encode's plain twin on the step's real leaf sets (34
    moments at block 256, 21 wire leaves at block 1024) against JAX's
    ``BlockwiseReference.encode`` leaf by leaf, with int8, int16, int32
    and float32 codes, all-zero blocks included, and ``encode_many`` as a
    loop of ``encode``;
(c) both layers' grouped fake-quant (``core/tt_layer.py::effective_cores``)
    against JAX's ``effective_cores``, values and the clipped-STE
    gradient with respect to the cores;
(d) the decode group: its plan (``bwd_plan``: tile prefix, chunks above
    the cap, 16-byte output offsets, 0-d and empty leaves) and its plain
    twin on the step's leaf sets in every storage against JAX's decode
    leaf by leaf (the reference, and the Pallas kernel in interpret mode
    for int8); ``decode_many`` as a loop of ``decode``; an int8-moment
    Adam update and a wire round trip through one ``decode_many`` each
    equal, bit for bit, to the per-leaf decodes they replaced.

Inputs are made with numpy from a seed and handed to both packages; the
params start from JAX's ``init_mlp`` and cross by ``mlp_params_from_jax``.
Tolerance: none, everything here is bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import numerics as JN  # noqa: E402
from repro.core import tt_layer as JTL  # noqa: E402
from repro.models import mlp_tt as JM  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.convert import mlp_params_from_jax  # noqa: E402
from repro_torch.core import tt_layer as TTL  # noqa: E402
from repro_torch.kernels import grouped as G  # noqa: E402
from repro_torch.models import mlp_tt as TM  # noqa: E402
from repro_torch.numerics import codecs  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.optim import adam as TA  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

STORAGES = [(8, "int8"), (16, "int16"), (24, "int32"), (16, "float32")]
TORCH_STORE = {"int8": torch.int8, "int16": torch.int16,
               "int32": torch.int32, "float32": torch.float32}


def _params():
    """JAX's init params and the port's copy of them (CPU)."""
    jp = JM.init_mlp(jax.random.PRNGKey(0), JM.make_mlp())
    return jp, mlp_params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")


def _moment_shapes(tp) -> list[tuple]:
    """m and v of every Adam leaf of the step: 34 tensors."""
    flat = dict(flatten_with_path(tp))
    shapes = [tuple(flat[p].shape) for p in TA.adam_leaf_paths(tp)]
    return shapes + shapes


def _wire_lengths(tp) -> list[int]:
    """Every floating leaf, flattened (the wire's view): 21 tensors."""
    return [leaf.numel() for _, leaf in flatten_with_path(tp)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]


def _view2d(shape) -> tuple[int, int]:
    """The (rows, last) view the codec encodes (0-d: one element)."""
    last = shape[-1] if shape else 1
    return (int(np.prod(shape)) // last if last else 0, last)


# ---------------------------------------------------------------------------
# (a) launch plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", list(TORCH_STORE.values()))
def test_bw_plan_chunks_above_the_cap_with_aligned_codes(storage):
    rng = np.random.RandomState(storage.itemsize)
    shapes = [(int(rng.randint(0, 4)), int(rng.randint(0, 700)))
              for _ in range(G.BW_CAP + 1)]
    plan = G.bw_plan(shapes, 256, storage)
    assert [list(p.index) for p in plan] == [list(range(G.BW_CAP)),
                                              [G.BW_CAP]]
    for launch in plan:
        ends = 0
        code_end = scale_end = 0
        for leaf, end, i in zip(launch.leaves, launch.task_end, launch.index):
            b, nb, _ = TN.blockwise_geometry(TN.QuantSpec("blockwise", 8, 256),
                                             shapes[i][1])
            assert (leaf.rows, leaf.last, leaf.b, leaf.nb) == \
                (*shapes[i], b, nb)
            assert end - ends == leaf.tasks
            ends = end
            assert (leaf.code_off * storage.itemsize) % 16 == 0
            assert leaf.code_off >= code_end and leaf.scale_off == scale_end
            code_end = leaf.code_off + leaf.codes
            scale_end = leaf.scale_off + leaf.scales
        assert launch.codes >= code_end and launch.codes - code_end < 16
        assert launch.scales == scale_end and launch.tasks == ends


def test_bw_plan_task_prefix_mixes_thread_and_warp_blocks():
    """One group holds leaves coded 32 blocks a warp (b <= 32) and one block
    a warp (b > 32): the wire's 4,096 at 1,024 (4 blocks), a moment of
    4,096 one-wide blocks, 16 and 33 one-block leaves, a (3, 1000)."""
    plan = G.bw_plan([(1, 4096), (4096, 1), (1, 16), (1, 33), (3, 1000),
                      (70, 16)], 1024)
    assert len(plan) == 1
    (launch,) = plan
    assert [(lf.b, lf.nb, lf.tasks) for lf in launch.leaves] == [
        (1024, 4, 4), (1, 1, 128), (16, 1, 1), (33, 1, 1), (1000, 1, 3),
        (16, 1, 3)]
    assert launch.task_end == (4, 132, 133, 134, 137, 140)
    assert [lf.code_off for lf in launch.leaves] == [
        0, 4096, 8192, 8208, 8256, 11264]
    assert launch.codes == 11264 + 1120
    assert launch.scales == 4 + 4096 + 1 + 1 + 3 + 70


def test_bw_plan_zero_d_one_element_and_empty_leaves():
    plan = G.bw_plan([_view2d(()), (1, 1), (0, 5), (2, 0)], 256,
                     torch.int16)
    (launch,) = plan
    assert [(lf.rows, lf.last, lf.b, lf.nb, lf.tasks, lf.code_off)
            for lf in launch.leaves] == [(1, 1, 1, 1, 1, 0),
                                         (1, 1, 1, 1, 1, 8),
                                         (0, 5, 5, 1, 0, 16),
                                         (2, 0, 1, 0, 0, 16)]
    assert launch.task_end == (1, 2, 2, 2) and launch.codes == 16
    assert launch.scales == 2
    assert G.bw_plan([], 256) == [] and G.fq_plan([]) == []


def test_step_leaf_sets_are_one_launch_each():
    _, tp = _params()
    moments = [_view2d(s) for s in _moment_shapes(tp)]
    wire = [(1, n) for n in _wire_lengths(tp)]
    assert (len(moments), len(wire)) == (34, 21)
    assert len(G.bw_plan(moments, 256)) == len(G.bw_plan(wire, 1024)) == 1
    # the moment set mixes b = 1, 16 and 256
    assert {lf.b for lf in G.bw_plan(moments, 256)[0].leaves} == {1, 16, 256}


@pytest.mark.parametrize("n", [1, 4, G.FQ_CAP, G.FQ_CAP + 1,
                               2 * G.FQ_CAP + 3])
def test_fq_plan_tile_prefix_and_chunks(n):
    rng = np.random.RandomState(n)
    numels = [int(v) for v in rng.randint(0, 5000, n)]
    plan = G.fq_plan(numels)
    assert [i for p in plan for i in p.index] == list(range(n))
    assert all(len(p.index) <= G.FQ_CAP for p in plan)
    assert len(plan) == -(-n // G.FQ_CAP)
    for p in plan:
        tiles = [-(-numels[i] // G.FQ_TILE) for i in p.index]
        assert p.tile_end == tuple(np.cumsum(tiles).tolist())


def test_fq_plan_of_the_layers_cores():
    _, tp = _params()
    for layer, spec, ends in (("l1", TM.make_mlp().spec1, (1, 5, 6, 10)),
                              ("l2", TM.make_mlp().spec2, (1, 5))):
        numels = [c.numel() for c in TTL.get_cores(tp[layer], spec)]
        (launch,) = G.fq_plan(numels)
        assert launch.tile_end == ends, (layer, numels)


# ---------------------------------------------------------------------------
# (b) the group encode's twin on the step's leaf sets
# ---------------------------------------------------------------------------

def _leaf_data(shapes, seed):
    """f32 data per shape; the first quarter of each leaf is zero, so every
    block width of the set has an all-zero block."""
    rng = np.random.RandomState(seed)
    out = []
    for shape in shapes:
        x = np.asarray(rng.standard_normal(shape) * 0.05, np.float32)
        flat = x.reshape(-1)
        flat[:max(1, flat.size // 4) if flat.size > 1 else 0] = 0.0
        out.append(x)
    return out


@pytest.mark.parametrize("bits,storage", STORAGES)
@pytest.mark.parametrize("leaf_set", ["moments", "wire"])
def test_group_encode_twin_equals_jax_per_leaf(leaf_set, bits, storage):
    _, tp = _params()
    if leaf_set == "moments":
        shapes, block = _moment_shapes(tp), 256
    else:
        shapes, block = [(n,) for n in _wire_lengths(tp)], 1024
    xs = _leaf_data(shapes, seed=len(shapes) + bits)
    jspec = JN.QuantSpec("blockwise", bits, block, storage, "per_tensor_max")
    got = CB.bw_encode_many_plain(
        [torch.from_numpy(x).reshape(_view2d(x.shape)) for x in xs], block,
        bits, TORCH_STORE[storage])
    zero_blocks = 0
    for x, (codes, scales) in zip(xs, got):
        jq = JN.encode(jnp.asarray(x), jspec)
        rows, _ = _view2d(x.shape)
        want_c = np.asarray(jq.codes).reshape(rows, -1)
        want_s = np.asarray(jq.scale).reshape(rows, -1)
        assert codes.dtype == TORCH_STORE[storage]
        np.testing.assert_array_equal(codes.numpy(), want_c)
        np.testing.assert_array_equal(scales.numpy().view(np.int32),
                                      want_s.view(np.int32))
        zero_blocks += int((want_s == 0).sum())
    assert zero_blocks > 0


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("bits,storage", STORAGES)
def test_encode_many_is_a_loop_of_encode(backend, bits, storage):
    _, tp = _params()
    shapes = _moment_shapes(tp) + [(3, 1000), (0, 7)]
    xs = [torch.from_numpy(x) for x in _leaf_data(shapes, seed=bits)]
    spec = TN.QuantSpec("blockwise", bits, 256, storage, "per_tensor_max")
    many = TN.encode_many(xs, spec, backend=backend)
    assert len(many) == len(xs)
    for x, qt in zip(xs, many):
        one = TN.encode(x, spec, backend=backend)
        assert qt.shape == one.shape and qt.spec == one.spec
        assert torch.equal(qt.codes, one.codes)
        assert torch.equal(qt.scale.view(torch.int32),
                           one.scale.view(torch.int32))
        assert torch.equal(TN.decode(qt, backend=backend),
                           TN.decode(one, backend=backend))


def test_grouped_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(8)
    with pytest.raises(ValueError):
        CB.bw_encode_many([x.reshape(2, 4), x], 256)
    with pytest.raises(ValueError):
        CB.fake_quant_scalar_many([x, x], torch.zeros(3), 4)
    assert CB.bw_encode_many([], 256) == []
    assert CB.fake_quant_scalar_many([], torch.zeros(0), 4) == []


# ---------------------------------------------------------------------------
# (c) a layer's cores in one grouped fake-quant
# ---------------------------------------------------------------------------

def _layer_inputs(jp, layer, spec, seed):
    """The layer's params with cores drawn at 3x their init spread (so the
    4-bit grid clips some elements) and λ with entries under the prune
    threshold x max λ (so the rank masks cut slices)."""
    rng = np.random.RandomState(seed)
    p = {k: np.asarray(v) for k, v in jp[layer].items()}
    for n in range(spec.d):
        c = p[f"core_{n}"]
        p[f"core_{n}"] = np.asarray(
            rng.standard_normal(c.shape) * 3 * c.std(), np.float32)
    for n in range(spec.d - 1):
        lam = np.asarray(rng.uniform(0.5, 1.0, p[f"lambda_{n}"].shape),
                         np.float32)
        lam[::4] = 1e-3                  # under 1e-2 x max λ: pruned
        p[f"lambda_{n}"] = lam
    return p


@pytest.mark.parametrize("layer", ["l1", "l2"])
def test_layer_cores_grouped_fake_quant_equals_jax(layer):
    jp, _ = _params()
    jd, td = JM.make_mlp(), TM.make_mlp()
    jspec, tspec = getattr(jd, f"spec{layer[1]}"), getattr(td,
                                                           f"spec{layer[1]}")
    p = _layer_inputs(jp, layer, jspec, seed=int(layer[1]))
    weights = [np.random.RandomState(10 + n).standard_normal(
        p[f"core_{n}"].shape).astype(np.float32) for n in range(jspec.d)]

    def jloss(cores):
        params = {**{k: jnp.asarray(v) for k, v in p.items()},
                  **{f"core_{n}": c for n, c in enumerate(cores)}}
        eff = JTL.effective_cores(params, jspec, jd.tt, jd.qc)
        return sum(jnp.sum(jnp.asarray(w) * e) for w, e in zip(weights, eff))

    jcores = [jnp.asarray(p[f"core_{n}"]) for n in range(jspec.d)]
    jparams = {**{k: jnp.asarray(v) for k, v in p.items()}}
    jeff = JTL.effective_cores(jparams, jspec, jd.tt, jd.qc)
    jgrad = jax.grad(jloss)(jcores)

    tparams = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tcores = [tparams[f"core_{n}"].requires_grad_() for n in range(tspec.d)]
    teff = TTL.effective_cores(tparams, tspec, td.tt, td.qc)
    loss = sum(torch.sum(torch.from_numpy(w) * e)
               for w, e in zip(weights, teff))
    tgrad = torch.autograd.grad(loss, tcores)

    clipped = masked = 0
    for n in range(tspec.d):
        np.testing.assert_array_equal(teff[n].detach().numpy(),
                                      np.asarray(jeff[n]), err_msg=str(n))
        np.testing.assert_array_equal(tgrad[n].numpy(), np.asarray(jgrad[n]),
                                      err_msg=str(n))
        step = float(p["wscale_log2"][n])
        inside = codecs.pow2_inside(tcores[n].detach(), step, 4)
        clipped += int((~inside).sum())
        masked += int((tgrad[n] == 0).sum())
    assert clipped > 0 and masked > clipped      # the STE and the masks cut


def test_grouped_fake_quant_twin_and_backends_agree():
    """The cuda codec's grouped fake-quant on CPU tensors (the kernel's
    twin) == the reference codec's loop == ``fake_quant_plain`` per core,
    in f32 and bf16."""
    rng = np.random.RandomState(7)
    spec = TN.QuantSpec("pow2", 4, 0, "int8", "fixed")
    steps = torch.tensor([-4.0, -3.0, -5.0, -2.0])
    for dtype in (torch.float32, torch.bfloat16):
        xs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                               * 0.3).to(dtype)
              for s in ((1, 4, 7, 16), (16, 4, 4, 16), (16, 2, 2, 16), (5,))]
        many = TN.fake_quant_many(xs, spec, steps, backend="cuda")
        ref = TN.fake_quant_many(xs, spec, steps)
        twin = CB.fake_quant_many_plain(xs, steps, 4)
        for n, x in enumerate(xs):
            one = CB.fake_quant_plain(x, steps[n], 4)
            assert many[n].dtype == dtype
            assert torch.equal(many[n], one) and torch.equal(ref[n], one)
            assert torch.equal(twin[n], one)


# ---------------------------------------------------------------------------
# (d) the decode group
# ---------------------------------------------------------------------------

def _bwd_leaf(shape, block):
    """(rows, last, b, nb) of a leaf of ``shape`` at ``block``."""
    rows, last = _view2d(shape)
    b, nb, _ = TN.blockwise_geometry(TN.QuantSpec("blockwise", 8, block),
                                     last)
    return rows, last, b, nb


def test_bwd_plan_chunks_above_the_cap_with_aligned_outputs():
    rng = np.random.RandomState(5)
    leaves = [_bwd_leaf((int(rng.randint(0, 4)), int(rng.randint(0, 3000))),
                        256) for _ in range(G.BW_CAP + 1)]
    plan = G.bwd_plan(leaves)
    assert [list(p.index) for p in plan] == [list(range(G.BW_CAP)),
                                              [G.BW_CAP]]
    for launch in plan:
        ends = out_end = 0
        for leaf, end, i in zip(launch.leaves, launch.tile_end, launch.index):
            assert (leaf.rows, leaf.last, leaf.b, leaf.nb) == leaves[i]
            assert leaf.tiles == -(-leaf.numel // G.BWD_TILE)
            assert end - ends == leaf.tiles
            ends = end
            assert (leaf.out_off * 4) % 16 == 0 and leaf.out_off >= out_end
            assert leaf.out_off - out_end < G.OUT_ALIGN
            out_end = leaf.out_off + leaf.numel
        assert launch.out >= out_end and launch.out - out_end < G.OUT_ALIGN
        assert launch.tiles == ends


def test_bwd_plan_tiles_of_the_step_sets():
    """Each set is one launch; a tile never straddles two leaves, so a
    4,096-element leaf takes 4 tiles and every leaf of at most 1,024
    elements one."""
    _, tp = _params()
    for shapes, block in ((_moment_shapes(tp), 256),
                          ([(n,) for n in _wire_lengths(tp)], 1024)):
        (launch,) = G.bwd_plan([_bwd_leaf(s, block) for s in shapes])
        n = [int(np.prod(s)) for s in shapes]
        assert [lf.tiles for lf in launch.leaves] == [-(-k // 1024) for k in n]
        assert launch.tile_end == tuple(np.cumsum(
            [-(-k // 1024) for k in n]).tolist())
        assert launch.out == sum(-(-k // 4) * 4 for k in n)
    (wire,) = G.bwd_plan([_bwd_leaf((n,), 1024) for n in _wire_lengths(tp)])
    # 14,873 elements in 30 tiles: each 4,096-element leaf takes 4
    assert wire.tiles == 30 and max(lf.tiles for lf in wire.leaves) == 4


def test_bwd_plan_zero_d_and_empty_leaves():
    plan = G.bwd_plan([_bwd_leaf((), 256), (0, 5, 5, 1), (2, 0, 1, 0),
                       _bwd_leaf((3,), 256), _bwd_leaf((2, 1000), 256)])
    (launch,) = plan
    assert [(lf.tiles, lf.out_off) for lf in launch.leaves] == [
        (1, 0), (0, 4), (0, 4), (1, 4), (2, 8)]
    assert launch.tile_end == (1, 1, 1, 2, 4) and launch.out == 2008
    assert G.bwd_plan([]) == []


def _jax_encoded(leaf_set, bits, storage):
    """JAX's blockwise encode of a step leaf set: (numpy inputs, JAX
    QTensors, block)."""
    _, tp = _params()
    if leaf_set == "moments":
        shapes, block = _moment_shapes(tp), 256
    else:
        shapes, block = [(n,) for n in _wire_lengths(tp)], 1024
    xs = _leaf_data(shapes, seed=3 * len(shapes) + bits)
    jspec = JN.QuantSpec("blockwise", bits, block, storage, "per_tensor_max")
    return xs, [JN.encode(jnp.asarray(x), jspec) for x in xs], block


@pytest.mark.parametrize("bits,storage", STORAGES)
@pytest.mark.parametrize("leaf_set", ["moments", "wire"])
def test_group_decode_twin_equals_jax_per_leaf(leaf_set, bits, storage,
                                               monkeypatch):
    xs, jqs, block = _jax_encoded(leaf_set, bits, storage)
    codes = [torch.from_numpy(np.array(q.codes).reshape(-1,
                                                        q.codes.shape[-1]))
             for q in jqs]
    scales = [torch.from_numpy(np.array(q.scale).reshape(
        -1, q.scale.shape[-1])) for q in jqs]
    lasts = [x.shape[-1] if x.ndim else 1 for x in xs]
    got = CB.bw_decode_many_plain(codes, scales, lasts)
    spec = TN.QuantSpec("blockwise", bits, block, storage, "per_tensor_max")
    tqs = [TN.QTensor(c.reshape(tuple(q.codes.shape)),
                      s.reshape(tuple(q.scale.shape)), spec, tuple(q.shape))
           for c, s, q in zip(codes, scales, jqs)]
    api = TN.decode_many(tqs, backend="cuda")
    if storage == "int8":       # the step's storage: the Pallas kernel too
        monkeypatch.setenv("JAX_PALLAS_INTERPRET", "1")
    for q, y, a, c in zip(jqs, got, api, codes):
        want = np.asarray(JN.decode(q)).reshape(y.shape)
        assert y.dtype == torch.float32 and c.dtype == TORCH_STORE[storage]
        np.testing.assert_array_equal(y.numpy().view(np.int32),
                                      want.view(np.int32))
        assert tuple(a.shape) == tuple(q.shape)
        np.testing.assert_array_equal(a.numpy().reshape(y.shape), y.numpy())
        if storage == "int8":
            pallas = np.asarray(JN.decode(q, backend="pallas"))
            np.testing.assert_array_equal(
                pallas.reshape(y.shape).view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_decode_many_is_a_loop_of_decode(backend):
    _, tp = _params()
    shapes = _moment_shapes(tp) + [(3, 1000), (0, 7), ()]
    xs = [torch.from_numpy(x) for x in _leaf_data(shapes, seed=4)]
    qts = []
    for i, x in enumerate(xs):           # every storage, three block widths
        bits, storage = STORAGES[i % len(STORAGES)]
        spec = TN.QuantSpec("blockwise", bits, (256, 16, 1024)[i % 3],
                            storage, "per_tensor_max")
        qts.append(TN.encode(x, spec, backend=backend))
    many = TN.decode_many(qts, backend=backend)
    assert len(many) == len(qts) and TN.decode_many([]) == []
    for qt, y in zip(qts, many):
        one = TN.decode(qt, backend=backend)
        assert y.shape == one.shape and y.dtype == one.dtype
        assert torch.equal(y.view(torch.int32), one.view(torch.int32))


def test_group_decode_wrapper_refuses_what_it_does_not_take():
    c, s = torch.zeros((2, 8), dtype=torch.int8), torch.zeros((2, 2))
    with pytest.raises(ValueError):
        CB.bw_decode_many([c, c], [s], [8, 8])
    with pytest.raises(ValueError):           # 8 codes in 3 blocks
        CB.bw_decode_many([c], [torch.zeros((2, 3))], [8])
    with pytest.raises(ValueError):           # no blocks for 4 values
        CB.bw_decode_many([c[:, :0]], [s[:, :0]], [4])
    assert CB.bw_decode_many([], [], []) == []
    y = CB.bw_decode_many([c[:, :0]], [s[:, :0]], [0])[0]
    assert tuple(y.shape) == (2, 0)


def _per_leaf_decode(qts, dtype=torch.float32, backend="reference"):
    """The decode before the group: one ``decode`` a leaf."""
    return [TN.decode(qt, dtype, backend=backend) for qt in qts]


def test_adam_and_wire_step_bit_for_bit_with_per_leaf_decodes(monkeypatch):
    """Two int8-moment AdamW updates after a wire round trip each, on the
    CPU: the grouped ``decode_many`` gives params, moments, compressed
    grads and residuals bit for bit equal to one ``decode`` a leaf."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import grad_compress as TG
    from repro_torch.tree import leaves, unflatten
    _, tp = _params()
    cfg = TrainConfig(learning_rate=3e-3, opt_state_dtype="int8")
    rng = np.random.RandomState(11)
    grads = [unflatten(tp, [
        torch.from_numpy(np.asarray(rng.standard_normal(tuple(v.shape))
                                    * 0.01, np.float32))
        if isinstance(v, torch.Tensor) and v.is_floating_point() else None
        for _, v in flatten_with_path(tp)]) for _ in range(2)]

    def run():
        params, state, res, out = tp, TA.init_adam(tp, cfg), None, []
        for g in grads:
            gc, res = TG.compress_decompress(g, res)
            params, state = TA.adam_update(params, gc, state, 3e-3, cfg)
            out += [t for t in leaves(gc) if t is not None]
            out += [t for t in res if t is not None]
        out += [t for t in leaves(params) if isinstance(t, torch.Tensor)]
        for m in (*state.m, *state.v):
            if m is not None:
                out += [m.codes, m.scale]
        return out

    grouped = run()
    monkeypatch.setattr(TA, "decode_many", _per_leaf_decode)
    monkeypatch.setattr(TG, "decode_many", _per_leaf_decode)
    per_leaf = run()
    assert len(grouped) == len(per_leaf) > 100
    for a, b in zip(grouped, per_leaf):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
