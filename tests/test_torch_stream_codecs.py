"""The stream routes of the grouped fake-quant and blockwise encode
launches (``kernels/grouped.py``: the fake-quant group's wide units, the
blockwise encode group's stream tasks) against repro (the JAX reference),
on the CPU.

On the card the LM step's large entries (its grad-edge group's embedding
and head, its activation edges, the embedding's and the head's moments,
the wire group's large leaves) take those routes, and the MLP's tensors
keep the units sized for launch latency. Here, where no kernel runs, the
tests hold what the card's launches rest on:

(a) the plans, pure functions of the shapes: the route each of the LM
    step's and the MLP steps' entries takes; the unit and task prefixes
    and the chunking above the cap with stream entries mixed in; the
    launch tables within the 4 KB of a launch's parameters;
(b) the arithmetic of a wide unit: ``x * 2^-s`` in place of ``x / 2^s``
    for integer |s| <= 126 gives the plain version's bits, subnormal
    results and zeros' sign included, and a wide unit's vectors cover a
    tensor once; a stream task's code of |x| < d / 4 as a signed zero
    without dividing gives the division's bits;
(c) a plain mirror of a stream task's walk (the first block's row by one
    division, then (row, block) stepped without one; each step's blocks
    loaded as float4 slots, pads as zeros) equal to the plain version,
    every block coded once, at (k, 2048) and (k, 896) in blocks of 256,
    rows of one block, and a flattened leaf at 1,024 with a ragged last
    block;
(d) the plain versions against JAX at those shapes: the blockwise encode
    against JAX's reference and its Pallas kernel in interpret mode, the
    fake-quant group against JAX's reference and Pallas fake-quant, and
    at ``STREAM_MIN`` elements against JAX's reference.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: none, everything here is bit-exact.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import numerics as JN  # noqa: E402
from repro.models import mlp_tt as JM  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.convert import mlp_params_from_jax  # noqa: E402
from repro_torch.core import tt_layer as TTL  # noqa: E402
from repro_torch.kernels import grouped as G  # noqa: E402
from repro_torch.models import mlp_tt as TM  # noqa: E402
from repro_torch.models.lm import build_lm, init_lm  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.optim import adam as TA  # noqa: E402
from repro_torch.tree import flatten_with_path, stacked_groups  # noqa: E402

CSRC = Path(TN.__file__).resolve().parents[1] / "kernels" / "csrc"


def _lm_leaves():
    """(path, shape, dtype) of every leaf of the LM the card trains:
    ``with_tt(internlm2-1.8b, quantize=True)``, on the meta device."""
    lm = build_lm(C.with_tt(C.get_config("internlm2-1.8b"), quantize=True))
    return lm, [(p, tuple(t.shape), t.dtype) for p, t in flatten_with_path(
        init_lm(None, lm, device="meta"))]


def _view2d(shape) -> tuple[int, int]:
    last = shape[-1] if shape else 1
    return (int(np.prod(shape)) // last if last else 0, last)


# ---------------------------------------------------------------------------
# (a) the plans
# ---------------------------------------------------------------------------

def test_plan_sends_the_lm_steps_large_entries_to_the_stream_route():
    lm, flat = _lm_leaves()
    big = {"embed/w", "head/w"}
    # the grad-edge group: the first FQ_CAP bf16 leaves, one launch
    grads = [(p, s) for p, s, dt in flat if dt == torch.bfloat16][:G.FQ_CAP]
    (launch,) = G.fq_plan([int(np.prod(s)) for _, s in grads], 2)
    assert [p for (p, _), w in zip(grads, launch.wide) if w] == \
        ["embed/w", "head/w"]
    # an activation edge: 8 x 256 x d_model bf16, a group of one
    (edge,) = G.fq_plan([8 * 256 * lm.cfg.d_model], 2)
    assert edge.wide == (True,)
    assert edge.tile_end == (8 * 256 * lm.cfg.d_model // 8192,)
    # the moment group that holds the embedding's m: stream tasks for the
    # embedding's and the head's, the previous tasks for the rest
    adam = [(p, s) for p, s, dt in flat if TA._is_adam_leaf(
        p, torch.empty(s, dtype=dt, device="meta"))]
    first = adam[:G.BW_CAP]
    (mg,) = G.bw_plan([_view2d(s) for _, s in first], 256)
    assert {p for (p, _), lf in zip(first, mg.leaves) if lf.stream} == big
    assert {lf.b for lf in mg.leaves if lf.stream} == {256}
    # the wire group: every reference leaf flattened, one launch; stream
    # tasks for every leaf of STREAM_MIN elements or more
    floats = [(p, s) for p, s, dt in flat if dt.is_floating_point]
    lengths = [sum(int(np.prod(floats[i][1])) for i in grp)
               for grp in stacked_groups([p for p, _ in floats])]
    (wire,) = G.bw_plan([(1, n) for n in lengths], 1024)
    assert [lf.stream for lf in wire.leaves] == \
        [n >= G.STREAM_MIN for n in lengths]
    assert sum(lf.stream for lf in wire.leaves) >= 2
    assert max(n for n in lengths if n < G.STREAM_MIN) > 0


def test_plan_keeps_the_mlp_steps_on_the_previous_units():
    """The FMNIST MLP's groups (train_fmnist's cores and edges, train_wire's
    34 moments and 21 wire leaves) take the units they took before."""
    d = TM.make_mlp()
    jp = JM.init_mlp(jax.random.PRNGKey(0), JM.make_mlp())
    tp = mlp_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for layer, spec in (("l1", d.spec1), ("l2", d.spec2)):
        numels = [c.numel() for c in TTL.get_cores(tp[layer], spec)]
        for itemsize in (4, 2):
            (launch,) = G.fq_plan(numels, itemsize)
            assert not any(launch.wide)
            assert launch == G.fq_plan(numels, itemsize, stream=False)[0]
    for edge in ((64, 896), (64, 512), (64, 16)):
        assert G.fq_unit(int(np.prod(edge)), 4) == G.FQ_TILE
    flat = dict(flatten_with_path(tp))
    moments = [_view2d(tuple(flat[p].shape)) for p in TA.adam_leaf_paths(tp)]
    wire = [(1, v.numel()) for v in flat.values()
            if isinstance(v, torch.Tensor) and v.is_floating_point()]
    for shapes, block in ((moments + moments, 256), (wire, 1024)):
        (launch,) = G.bw_plan(shapes, block)
        assert not any(lf.stream for lf in launch.leaves)
        assert launch == G.bw_plan(shapes, block, stream=False)[0]


@pytest.mark.parametrize("n", [1, 3, G.FQ_CAP, G.FQ_CAP + 1,
                               2 * G.FQ_CAP + 5])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_fq_plan_unit_prefix_with_wide_entries(n, itemsize):
    rng = np.random.RandomState(n + itemsize)
    numels = [int(v) for v in rng.randint(0, 5000, n)]
    for i in range(0, n, 3):
        numels[i] = G.STREAM_MIN + int(rng.randint(0, 70000))
    plan = G.fq_plan(numels, itemsize)
    assert [i for p in plan for i in p.index] == list(range(n))
    assert len(plan) == -(-n // G.FQ_CAP)
    wide_unit = G.FQ_WIDE_BYTES // itemsize
    assert wide_unit == 256 * 4 * (16 // itemsize)   # pow2_fq.cu wide_tile
    for p in plan:
        units = [-(-numels[i] // (wide_unit if numels[i] >= G.STREAM_MIN
                                  else G.FQ_TILE)) for i in p.index]
        assert p.tile_end == tuple(np.cumsum(units).tolist())
        assert p.wide == tuple(numels[i] >= G.STREAM_MIN for i in p.index)
    for p in G.fq_plan(numels, itemsize, stream=False):
        assert not any(p.wide)
        assert p.tile_end == tuple(np.cumsum(
            [-(-numels[i] // G.FQ_TILE) for i in p.index]).tolist())


@pytest.mark.parametrize("block", [256, 1024])
def test_bw_plan_task_prefix_with_stream_leaves(block):
    """Stream leaves beside lane and warp leaves in one group, then past
    the cap: each stream leaf's tasks are its blocks over
    ``BW_STREAM_STEPS`` steps of 1024 / b blocks; offsets as before."""
    m = G.STREAM_MIN
    shapes = [(m // 2048, 2048), (4096, 16), (1, m + 384), (3, 1000),
              (1, m + 2), (m // 896 + 1, 896), (7, 1)] * 8
    plan = G.bw_plan(shapes, block)
    assert [list(p.index) for p in plan] == [list(range(G.BW_CAP)),
                                             list(range(G.BW_CAP, 56))]
    for launch in plan:
        ends = code_end = 0
        for i, leaf, end in zip(launch.index, launch.leaves,
                                launch.task_end):
            rows, last = shapes[i]
            b, nb, _ = TN.blockwise_geometry(
                TN.QuantSpec("blockwise", 8, block), last)
            want = G.bw_stream(rows, last, b)
            assert leaf.stream == want == (
                rows * last >= m and last % 4 == 0
                and b in (256, 512, 1024))
            per = G.BW_STREAM_STEPS * (1024 // b) if want else (
                32 if b <= 32 else 1)
            assert leaf.tasks == -(-(rows * nb) // per) == end - ends
            ends = end
            assert leaf.code_off >= code_end and leaf.code_off % 16 == 0
            code_end = leaf.code_off + leaf.codes
        assert launch.tasks == ends


_SIZES = {"const": None, "long long": 8, "int": 4, "float": 4}


def _struct_bytes(src: str, name: str, n: int) -> int:
    """Bytes of ``struct name`` of ``src`` at N = n: pointers and long long
    8, int and float 4, the struct padded to 8."""
    body = re.search(r"struct %s \{\n(.*?)\n\};" % name, src, re.S).group(1)
    total = 0
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        kind, names = re.match(
            r"((?:const\s+)?(?:long long|\w+)\s*\*?)\s*(.*)", decl).groups()
        size = 8 if "*" in kind or "long long" in kind else 4
        for d in names.split(","):
            total += size * (n if "[N]" in d else 1)
    return -(-total // 8) * 8


def test_launch_tables_fit_the_parameter_space():
    """The fake-quant table at ``FQ_CAP`` entries beside the kernel's three
    scalars, and the encode table at ``BW_CAP``, within 4 KB."""
    fq = (CSRC / "pow2_fq.cu").read_text()
    bw = (CSRC / "blockwise.cu").read_text()
    assert re.search(r"kFqCap = %d;" % G.FQ_CAP, fq)
    assert re.search(r"kBwCap = %d;" % G.BW_CAP, bw)
    assert re.search(r"kStreamSteps = %d;" % G.BW_STREAM_STEPS, bw)
    assert _struct_bytes(fq, "FqGroup", G.FQ_CAP) + 12 <= 4096
    assert _struct_bytes(bw, "BwGroup", G.BW_CAP) <= 4096
    assert _struct_bytes(fq, "FqGroup", 1) == 48
    assert _struct_bytes(bw, "BwGroup", 1) == 80


# ---------------------------------------------------------------------------
# (b) a wide unit's arithmetic
# ---------------------------------------------------------------------------

def _wide_mirror(x: torch.Tensor, s: float, bits: int) -> torch.Tensor:
    """The wide unit's fake-quant as the kernel computes it: the scale in
    x's dtype, x * 2^-s for an integer |s| <= 126, else x / scale, each
    step rounded to x's dtype."""
    t = x.dtype
    scale = torch.tensor(2.0 ** s, dtype=torch.float32).to(t).float()
    f = x.float()
    if s == int(s) and abs(s) <= 126:
        v = f * torch.tensor(2.0 ** -s, dtype=torch.float32)
    else:
        v = f / scale
    q = torch.round(v.to(t).float())
    lo = torch.tensor(-2.0 ** (bits - 1)).to(t).float()
    hi = torch.tensor(2.0 ** (bits - 1) - 1).to(t).float()
    q = torch.where(q < lo, lo, torch.where(q > hi, hi, q))
    return (q * scale).to(t)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.element_size() == 2 else
                  torch.int32).numpy()


@pytest.mark.parametrize("s", [-126.0, -60.0, -7.0, 0.0, 3.0, 126.0, -127.0,
                               127.0, -2.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_unit_product_is_the_division_bit_for_bit(dtype, s):
    """Normal, subnormal and zero inputs of both signs at a step whose
    results land in every range, 4, 8 and 16 bits."""
    rng = np.random.RandomState(int(abs(s)) + 3)
    mag = np.minimum(2.0 ** (s + np.array([-30, -8, 0, 8, 20, 40])), 1e37)
    x = np.concatenate([
        (rng.standard_normal((6, 500)) * mag[:, None]).reshape(-1),
        rng.standard_normal(300) * 1e-40, [0.0, -0.0, 1e-45, -1e-45]])
    xt = torch.from_numpy(np.asarray(x.reshape(-1), np.float32)).to(dtype)
    for bits in (4, 8, 16):
        got = _wide_mirror(xt, s, bits)
        want = CB.fake_quant_plain(xt, s, bits)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [G.STREAM_MIN, G.STREAM_MIN + 4096 + 8])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_wide_units_cover_a_tensor_once(n, itemsize):
    """Unit t, thread i, load k reads vector t * unit / per + i + 256 k:
    the plan's units cover the tensor's vectors once."""
    per = 16 // itemsize
    (launch,) = G.fq_plan([n], itemsize)
    unit = G.FQ_WIDE_BYTES // itemsize
    v = (np.arange(launch.tiles)[:, None, None] * (unit // per)
         + np.arange(256)[None, :, None] + 256 * np.arange(4)[None, None, :])
    v = np.sort(v.reshape(-1))
    np.testing.assert_array_equal(v[v < n // per], np.arange(n // per))
    assert launch.tiles * unit >= n > (launch.tiles - 1) * unit


# ---------------------------------------------------------------------------
# (c) a stream task's walk
# ---------------------------------------------------------------------------

def _stream_mirror(x2d: np.ndarray, block: int, bits: int, tasks: int):
    """The stream tasks' codes and scales as the kernel walks them: task t
    starts at block u0 = t * S * G (S steps, G = 1024 / b blocks a step),
    its row by one division; each step copies G blocks as V = b / 128
    float4 slots a lane (a slot past the block's real elements is zeros),
    steps (row, block) without a division, and codes each block as
    ``bw_code_stream`` does. Returns (codes, scales, how often each block
    was coded)."""
    rows, last = x2d.shape
    b, nb, _ = TN.blockwise_geometry(TN.QuantSpec("blockwise", bits, block),
                                     last)
    g_steps, v_slots = 1024 // b, b // 128
    units = rows * nb
    qmax = np.float32(2 ** (bits - 1) - 1)
    codes = np.zeros((rows, nb * b), np.int8)
    scales = np.zeros((rows, nb), np.float32)
    seen = np.zeros(units, np.int64)
    lane_k = 4 * (np.arange(32)[:, None] + 32 * np.arange(v_slots)[None, :])
    steps = G.BW_STREAM_STEPS
    for t in range(tasks):
        u0 = t * steps * g_steps
        r, j = divmod(u0, nb)
        for step in range(steps):
            for g in range(g_steps):
                u = u0 + step * g_steps + g
                n = min(b, last - j * b) if u < units else 0
                if n:
                    assert (r, j) == divmod(u, nb)
                    vals = np.zeros(b, np.float32)
                    for k in lane_k.reshape(-1):
                        if k < n:                   # a float4, all real
                            vals[k:k + 4] = x2d[r, j * b + k:j * b + k + 4]
                    amax = np.float32(np.abs(vals).max())
                    s = amax / qmax if amax > 0 else np.float32(0)
                    d = np.maximum(s, np.float32(1e-20))
                    q = _code_shortcut(vals, d, qmax)
                    q[n:] = 0
                    codes[r, j * b:(j + 1) * b] = q.astype(np.int8)
                    scales[r, j] = s
                    seen[u] += 1
                j += 1
                if j == nb:
                    j, r = 0, r + 1
    return codes, scales, seen


def _code_shortcut(v: np.ndarray, d: np.float32, qmax: np.float32):
    """``blockwise.cu::bw_code_stream`` in f32: |v| < d / 4 codes as a zero
    with v's sign without dividing, the rest as clip(rint(v / d))."""
    small = np.abs(v) < np.float32(0.25) * d
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        q = np.rint(np.where(small, d, v) / d)
    return np.clip(np.where(small, np.copysign(np.float32(0), v), q), -qmax,
                   qmax)


@pytest.mark.parametrize("d", [1e-20, 3.7e-12, 0.0123, 1.5, 2.6e36,
                               float("inf")])
def test_stream_code_shortcut_is_the_division_bit_for_bit(d):
    """Zeros of both signs, subnormals, values around d / 4 and d / 2,
    the grid's ends, inf and NaN: the shortcut's codes are the division's,
    bit for bit (float codes keep the zero's sign)."""
    d = np.float32(d)
    qmax = np.float32(127)
    rng = np.random.RandomState(3)
    fin = d if np.isfinite(d) else np.float32(1e30)
    v = np.concatenate([
        [0.0, -0.0, 1e-45, -1e-45, 1e-39, -1e-39, np.inf, -np.inf, np.nan],
        fin * np.array([0.25, -0.25, 0.2499999, 0.2500001, 0.5, -0.5, 0.49999,
                        1.5, 2.5, -2.5, 126.5, 127.0, -127.0, 127.4]),
        np.clip(fin * rng.standard_normal(4000)
                * 10.0 ** rng.uniform(-30, 2.2, 4000), -3e38, 3e38),
    ]).astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        want = np.clip(np.rint(v / d), -qmax, qmax)
    got = _code_shortcut(v, d, qmax)
    np.testing.assert_array_equal(got.view(np.int32)[~np.isnan(want)],
                                  want.view(np.int32)[~np.isnan(want)])
    assert np.isnan(got[np.isnan(want)]).all()
    assert (got == 0).sum() > 10


def _bw_data(shape, seed, zero: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    x = np.asarray(rng.standard_normal(shape) * 0.05, np.float32)
    x.reshape(-1)[:zero] = 0.0
    return x


# (rows, last) at block: (k, 2048) and (k, 896) at 256 (a ragged last block
# a row), rows of one block (G blocks a step cross rows), a flattened leaf
# at 1,024 with a ragged last block
WALKS = [((24, 2048), 256), ((13, 896), 256), ((37, 256), 256),
         ((1, 5 * 1024 + 384), 1024), ((3, 1024), 1024)]


@pytest.mark.parametrize("shape,block", WALKS)
def test_stream_task_walk_equals_the_plain_version(shape, block):
    x = _bw_data(shape, seed=shape[1], zero=block)
    rows, last = shape
    b, nb, _ = TN.blockwise_geometry(TN.QuantSpec("blockwise", 8, block),
                                     last)
    tasks = G.bw_tasks(rows, last, b, nb, stream=True)
    codes, scales, seen = _stream_mirror(x, block, 8, tasks)
    assert (seen == 1).all()
    rc, rs = CB.bw_encode_plain(torch.from_numpy(x), block)
    np.testing.assert_array_equal(codes, rc.numpy())
    np.testing.assert_array_equal(scales.view(np.int32),
                                  rs.numpy().view(np.int32))
    assert scales[0, 0] == 0 and not codes[0, :b].any()


# ---------------------------------------------------------------------------
# (d) the plain versions against JAX at the stream routes' shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,block", WALKS + [((1, G.STREAM_MIN + 384),
                                                  1024),
                                                 ((G.STREAM_MIN // 2048,
                                                   2048), 256)])
def test_group_encode_plain_equals_jax_at_stream_shapes(shape, block,
                                                        monkeypatch):
    """The group encode's plain version (the ``cuda`` codec on CPU tensors)
    == JAX's reference, and JAX's Pallas kernel in interpret mode at the
    small shapes: codes equal, scales bit for bit, the zero block zeros."""
    monkeypatch.setenv("JAX_PALLAS_INTERPRET", "1")
    xs = [_bw_data(shape, seed=7, zero=block), _bw_data((5, 30), seed=8)]
    jspec = JN.QuantSpec("blockwise", 8, block, "int8", "per_tensor_max")
    tspec = TN.QuantSpec("blockwise", 8, block, "int8", "per_tensor_max")
    got = TN.encode_many([torch.from_numpy(x) for x in xs], tspec,
                         backend="cuda")
    small = shape[0] * shape[1] < G.STREAM_MIN
    for x, tq in zip(xs, got):
        for backend in ("reference", "pallas") if small else ("reference",):
            jq = JN.encode(jnp.asarray(x), jspec, backend=backend)
            np.testing.assert_array_equal(tq.codes.numpy(),
                                          np.asarray(jq.codes))
            if backend == "reference":
                np.testing.assert_array_equal(
                    tq.scale.numpy().view(np.int32),
                    np.asarray(jq.scale).view(np.int32))
    assert got[0].scale.numpy()[0, 0] == 0
    assert not got[0].codes.numpy()[0, :min(block, shape[1])].any()


@pytest.mark.parametrize("dtype,bits", [("bfloat16", 16), ("bfloat16", 8),
                                        ("float32", 8), ("float32", 4)])
def test_fake_quant_group_plain_equals_jax_at_wide_shapes(dtype, bits):
    """The fake-quant group's plain version (``fake_quant_scalar_many`` on
    CPU tensors) == JAX's reference fake-quant tensor by tensor, bit for
    bit with zeros' sign, on a group with a tensor of ``STREAM_MIN``
    elements (wide units on the card) and small ones; the small ones also
    against JAX's Pallas fake-quant (interpret mode)."""
    rng = np.random.RandomState(bits)
    shapes = [(G.STREAM_MIN // 2048, 2048), (16, 16, 16, 16), (2048,),
              (8, 256, 64)]
    xs = [np.asarray(rng.standard_normal(s) * 0.3, np.float32)
          for s in shapes]
    xs[0].reshape(-1)[:4] = [0.0, -0.0, -1e-30, 1e-30]
    steps = np.array([-3.0, -5.0, -2.0, -7.0], np.float32)
    tt = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]
    got = CB.fake_quant_scalar_many(tt, torch.from_numpy(steps), bits)
    assert G.fq_plan([t.numel() for t in tt], tt[0].element_size())[0].wide \
        == (True, False, False, False)
    spec = JN.QuantSpec("pow2", bits)
    for i, (t, y) in enumerate(zip(tt, got)):
        jx = jnp.asarray(np.asarray(t.float()), dtype)
        backends = ("reference",) if i == 0 else ("reference", "pallas")
        for backend in backends:
            ref = JN.fake_quant(jx, spec, jnp.asarray(steps[i]),
                                backend=backend)
            want = np.asarray(ref).view(np.int16 if dtype == "bfloat16"
                                        else np.int32)
            np.testing.assert_array_equal(_bits(y), want)
