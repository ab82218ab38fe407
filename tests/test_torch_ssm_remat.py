"""The chunk remat of repro_torch's recurrent scans against repro (the JAX
reference): ``_selective_scan`` and ``_wkv6_scan`` run, while autograd
records, as a loop over chunks of ``SCAN_CHUNK`` tokens, each a
``_ScanChunk`` (its inputs and entry state kept, the chunk run again in
the backward), with the reference's chunk-length rule
(``min(SCAN_CHUNK, S)``, one chunk where S is not a multiple of it).

- Forward: the chunked scan's outputs and last state equal the unchunked
  token loop's and the grad-off scan's bit for bit (the chunks run the same
  per-token ops; stacking per chunk and concatenating adds no arithmetic).
- Backward: gradients wrt every input and the initial state within 1e-5 of
  their largest magnitude of ``jax.grad`` through the reference's scans
  with its ``SCAN_CHUNK`` patched alike (f32 sums in other orders).
- Memory: the bytes autograd saves outside the chunks are the inputs
  and one entry state a chunk, not one state a token; a chunk's forward
  runs once in the forward and once more in the backward; inside an LM
  under ``remat`` "none" and "full" the states alive at any time are at
  most one chunk's plus the chunks' entry states.
"""
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.ssm as JS  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import build_lm, init_lm, lm_forward  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

# (S, SCAN_CHUNK): four chunks; 12 % 8 != 0, so one chunk of 12
CASES = [(16, 4), (12, 8)]


def _chunks(s, chunk):
    n = min(chunk, s)
    return 1 if s % n else s // n


def _inputs(kind, s, seed=0):
    """Numpy inputs of one scan (the argument order of its signature)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    if kind == "ssm":
        b, di, n = 2, 6, 4
        return [rng.normal(size=(b, s, di)).astype(f),               # u
                np.abs(rng.normal(size=(b, s, di)) * 0.3).astype(f),  # dt
                -np.exp(rng.normal(size=(di, n)) * 0.5).astype(f),   # a
                rng.normal(size=(b, s, n)).astype(f),                # b_t
                rng.normal(size=(b, s, n)).astype(f),                # c_t
                rng.normal(size=(di,)).astype(f),                    # D
                rng.normal(size=(b, di, n)).astype(f)]               # h0
    b, h, d = 2, 2, 4
    return [rng.normal(size=(b, s, h, d)).astype(f),                 # r
            rng.normal(size=(b, s, h, d)).astype(f),                 # k
            rng.normal(size=(b, s, h, d)).astype(f),                 # v
            rng.uniform(0.5, 1.0, size=(b, s, h, d)).astype(f),      # w
            (rng.normal(size=(h, d)) * 0.1).astype(f),               # u
            rng.normal(size=(b, h, d, d)).astype(f)]                 # h0


SCANS = {"ssm": ("_selective_scan", "_ssm_steps", "_ssm_step"),
         "wkv6": ("_wkv6_scan", "_wkv6_steps", "_wkv6_step")}


def _steps_args(kind, xs):
    """The token loop's arguments ``(h, *seqs, *consts)`` of a scan's."""
    if kind == "ssm":
        u, dt, a, bt, ct, _, h0 = xs
        return (h0, u, dt, bt, ct, a)
    r, k, v, w, u, h0 = xs
    return (h0, r, k, v, w, u)


@pytest.mark.parametrize("s,chunk", CASES)
@pytest.mark.parametrize("kind", ["ssm", "wkv6"])
def test_chunked_scan_bits_and_gradients(monkeypatch, kind, s, chunk):
    monkeypatch.setattr(TS, "SCAN_CHUNK", chunk)
    monkeypatch.setattr(JS, "SCAN_CHUNK", chunk)
    scan, steps, _ = SCANS[kind]
    xs = _inputs(kind, s)
    rng = np.random.default_rng(1)
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    calls = {"n": 0}
    inner = getattr(TS, steps)

    def counted(*a):
        calls["n"] += 1
        return inner(*a)
    monkeypatch.setattr(TS, steps, counted)
    y, h = getattr(TS, scan)(*ts)
    assert calls["n"] == _chunks(s, chunk)     # one call a chunk
    ybar = rng.normal(size=tuple(y.shape)).astype(np.float32)
    hbar = rng.normal(size=tuple(h.shape)).astype(np.float32)
    ((y * torch.from_numpy(ybar)).sum()
     + (h * torch.from_numpy(hbar)).sum()).backward()
    # the backward recomputed each chunk once
    assert calls["n"] == 2 * _chunks(s, chunk)

    # forward: bit for bit the grad-off scan and the whole token loop
    with torch.no_grad():
        y0, h0 = getattr(TS, scan)(*ts)
        y1, h1 = inner(*_steps_args(kind, ts))
        if kind == "ssm":
            y1 = (y1 + ts[0] * ts[5][None, None]).to(ts[0].dtype)
    for a, b in ((y, y0), (h, h0), (y, y1), (h, h1)):
        assert torch.equal(a, b)

    def loss(*args):
        jy, jh = getattr(JS, scan)(*args)
        return jnp.sum(jy * ybar) + jnp.sum(jh * hbar)
    jy, jh = getattr(JS, scan)(*(jnp.asarray(x) for x in xs))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jy)).max())
    grads = jax.grad(loss, argnums=tuple(range(len(xs))))(
        *(jnp.asarray(x) for x in xs))
    for i, (t, g) in enumerate(zip(ts, grads)):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(),
                                   err_msg=f"{kind} input {i}")


def _saved_bytes(fn):
    n = [0]

    def pack(t):
        n[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return n[0]


@pytest.mark.parametrize("kind", ["ssm", "wkv6"])
def test_backward_saves_a_state_a_chunk_not_a_token(monkeypatch, kind):
    """At S = 64 the bytes autograd saves outside the chunks are at
    most the inputs plus one entry state (and the chunk's constant) a
    chunk: 8 at chunk 8, 1 at chunk 64 (the selective scan's skip term
    ``u * D`` saves u and D once more); the unchunked token loop saves
    more than a state a token."""
    s = 64
    scan, steps, _ = SCANS[kind]
    ts = [torch.from_numpy(x).requires_grad_() for x in _inputs(kind, s)]
    state = ts[-1].numel() * 4
    const = (ts[2] if kind == "ssm" else ts[4]).numel() * 4
    inputs = sum(t.numel() * 4 for t in ts) - state
    if kind == "ssm":
        inputs += (ts[0].numel() + ts[5].numel()) * 4
    got = {}
    for chunk in (8, 64):
        monkeypatch.setattr(TS, "SCAN_CHUNK", chunk)
        got[chunk] = _saved_bytes(lambda: getattr(TS, scan)(*ts))
        assert got[chunk] <= inputs + (s // chunk) * (state + const), \
            (chunk, got[chunk])
    assert got[64] < got[8]
    plain = _saved_bytes(lambda: getattr(TS, steps)(
        *_steps_args(kind, ts)))
    assert plain > s * state, plain


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large"])
def test_lm_backward_holds_one_chunk_of_states(monkeypatch, arch, remat):
    """A reduced LM's forward and backward with ``SCAN_CHUNK`` 4 at S = 16:
    every recurrent layer's scan runs in the forward, again in the layer's
    recompute under ``remat="full"``, and once more, a chunk at a time, in
    the backward; the step states alive at any time are at most the
    chunks' entry states of every recurrent layer plus one chunk's."""
    chunk, s = 4, 16
    monkeypatch.setattr(TS, "SCAN_CHUNK", chunk)
    over = ({"moe": MoEConfig(num_experts=0)} if arch.startswith("jamba")
            else {})
    cfg = TC.get_reduced(arch).replace(dtype="float32", remat=remat, **over)
    lm = build_lm(cfg)
    params = init_lm(torch.Generator().manual_seed(0), lm, device="cpu")
    leaves = [x for x in torch.utils._pytree.tree_leaves(params)
              if x.is_floating_point()]
    for x in leaves:
        x.requires_grad_()
    step = "_wkv6_step" if arch.startswith("rwkv") else "_ssm_step"
    inner = getattr(TS, step)
    live, seen = [], {"calls": 0, "alive": 0}

    def counted(*a):
        state, out = inner(*a)
        seen["calls"] += 1
        live.append(weakref.ref(state))
        seen["alive"] = max(seen["alive"],
                            sum(r() is not None for r in live))
        return state, out
    monkeypatch.setattr(TS, step, counted)
    kind = "rwkv6" if arch.startswith("rwkv") else "mamba"
    layers = lm.n_periods * sum(sub.mixer_kind == kind for sub in lm.period)
    tok = torch.randint(0, cfg.vocab_size, (2, s),
                        generator=torch.Generator().manual_seed(1))
    logits, _, _ = lm_forward(params, lm, tokens=tok)
    assert seen["calls"] == layers * s
    logits.square().mean().backward()
    fwd = 2 if remat == "full" else 1
    assert seen["calls"] == layers * (fwd + 1) * s
    assert seen["alive"] <= layers * (s // chunk) + chunk < layers * s
    assert all(x.grad is not None for x in leaves)
