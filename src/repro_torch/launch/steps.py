"""Train step factories of the zoo LM — the port of
``repro/launch/steps.py``'s single-program half: ``TrainState``, the loss,
the step with the policy's quant sites, and the gradient-accumulation step.

A step runs in the reference's order: the loss and its gradients (the
``activation`` edges live in the forward when the state carries managed
scales), the §3.3 manager on the observed activation statistic, the int8
gradient wire with error feedback (``grad_compress``), the ``grad_edge``
quantizer, global-norm clipping, AdamW (f32 or int8 moments), the Eq. 4 λ
update. Every value stays on the device: a step reads nothing back to
the host.

The port's params keep one dict per layer where the reference stacks
leaves (``tree.py``). Where the reference takes one statistic over a
stacked leaf, the port takes it over that leaf's per-layer tensors
together: the grad edge's per-tensor-max step and the wire's flattened
blockwise round trip (``optim/grad_compress.py``). So the two packages
quantize every gradient on the same grid.

Quant health (``policy.health`` with quantization on): the step's metrics
gain ``health``, the reference's ``_train_health`` — the grad edge's
saturated codes, counted inside its group fake-quant launches (one (2,)
int64 counter a step, on the device), and each managed site's scale,
statistic and whether it sits in the target band. Device tensors, like
every other metric: nothing is read back.

Not ported here: the data-parallel step and a ``plan`` with a mesh
(ROADMAP queue 1 item 8); it raises.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ckpt import Stacked, load
from ..configs.base import TrainConfig
from ..core.ttm import what_windows
from ..kernels import grouped as G
from ..models.lm import (LMDef, _walk_sites, init_lm, lm_forward,
                         lm_lambda_update, lm_prior_loss)
from ..numerics import NumericsPolicy, QTensor, per_tensor_max_scale_log2
from ..numerics import cuda_backend as CB
from ..optim.adam import (AdamState, _is_adam_leaf, _is_float, adam_update,
                          clip_by_global_norm, init_adam)
from ..optim.schedule import lr_at
from ..tree import flatten_with_path, stacked_groups, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: AdamState
    step: torch.Tensor
    residual: Any = None     # grad-compression error feedback (optional)
    scales: Any = None       # NumericsPolicy managed scale-state tree


def _no_mesh(plan) -> None:
    if plan is not None and getattr(plan, "mesh", None) is not None:
        raise NotImplementedError(
            "a plan with a mesh (the data-parallel and sharded steps) is "
            "not ported: ROADMAP queue 1 item 8")


def init_train_state(params, tcfg: TrainConfig,
                     policy: NumericsPolicy | None = None) -> TrainState:
    """Zero moments, step 0, a zero residual per floating leaf when the
    wire is on (None for the others), and the policy's scale tree when it
    is enabled; all on the params' device."""
    flat = flatten_with_path(params)
    device = next(leaf.device for _, leaf in flat if _is_float(leaf))
    residual = None
    if tcfg.grad_compress:
        residual = tuple(torch.zeros(leaf.shape, dtype=torch.float32,
                                     device=leaf.device)
                         if _is_float(leaf) else None for _, leaf in flat)
    scales = None
    if policy is not None and policy.enable:
        scales = policy.init_scales(device)
    return TrainState(params, init_adam(params, tcfg),
                      torch.zeros((), dtype=torch.int32, device=device),
                      residual, scales)


def train_state_sites(state: TrainState) -> dict[str, dict]:
    """Byte accounting of one TrainState by ``obs.ledger`` site: params,
    int8 Adam moments, the wire's error-feedback residual, the managed
    scale state; each beside what the same tensors would cost in f32."""
    from ..optim.adam import moment_nbytes
    from ..optim.grad_compress import residual_nbytes
    p_res = p_fp32 = 0
    for _, leaf in flatten_with_path(state.params):
        p_res += leaf.numel() * leaf.element_size()
        p_fp32 += 4 * leaf.numel()
    m_res, m_fp32 = moment_nbytes(state.opt)
    out = {
        "params": {"bytes": p_res, "fp32_bytes": p_fp32},
        "optimizer_moment": {"bytes": m_res, "fp32_bytes": m_fp32},
    }
    r = residual_nbytes(state.residual)
    if r:
        out["grad_residual"] = {"bytes": r, "fp32_bytes": r}
    if state.scales is not None:
        s = sum(t.numel() * t.element_size()
                for _, t in flatten_with_path(state.scales))
        out["scale_state"] = {"bytes": s, "fp32_bytes": s}
    return out


def _quantize_grad_edge(grads, scales, policy: NumericsPolicy, sat=None):
    """The ``grad_edge`` site at the step level: round every floating
    gradient onto the grad_bits pow-2 grid under a per-tensor-max step
    (clip-free), one step per reference leaf: the max runs over the
    leaf's per-layer tensors together. On the card one group fake-quant
    launch per dtype and ``grouped.FQ_CAP`` tensors, the steps read on the
    device. The managed ``grad_edge`` ScaleState advances on the mean
    |g| over every floating leaf. ``sat`` (a (2,) int64 tensor): the
    launches add (saturated, total) of the codes to it — the reference's
    ``tree_sat_stats(grads, grad_edge)``; without a managed ``grad_edge``
    scale the launches run for that count alone and the gradients pass
    through."""
    if scales is None or ("grad_edge" not in scales and sat is None):
        return grads, scales
    spec = policy.spec_for("grad_edge")
    flat = flatten_with_path(grads)
    live = [i for i, (_, g) in enumerate(flat) if _is_float(g)]
    steps: dict[int, torch.Tensor] = {}
    for group in stacked_groups([flat[i][0] for i in live]):
        members = [flat[live[k]][1] for k in group]
        amax = torch.stack([g.detach().abs().amax().float()
                            for g in members]).amax()
        step = per_tensor_max_scale_log2(amax, spec)
        for k in group:
            steps[live[k]] = step
    out = [g for _, g in flat]
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i in live:
        by_dtype.setdefault(flat[i][1].dtype, []).append(i)
    for idx in by_dtype.values():
        qs = CB.fake_quant_scalar_many([flat[i][1].detach() for i in idx],
                                       torch.stack([steps[i] for i in idx]),
                                       spec.bits, sat=sat)
        for i, q in zip(idx, qs):
            out[i] = q
    if "grad_edge" not in scales:
        return grads, scales
    tot = torch.stack([torch.sum(flat[i][1].abs(), dtype=torch.float32)
                       for i in live]).sum()
    cnt = sum(flat[i][1].numel() for i in live)
    gm = (tot / max(cnt, 1))[None]
    return unflatten(grads, out), policy.update_scales(scales,
                                                       {"grad_edge": gm})


def _train_health(sat: torch.Tensor, scales: dict,
                  policy: NumericsPolicy) -> dict:
    """Per-site quant-health aggregates of one train step — the
    reference's ``_train_health``. ``sat`` is the (saturated, total) of the
    grad edge's codes (counted by its launches, under the per-tensor-max
    steps the quantizer uses: clip-free, so saturation means values AT
    max|g|). Each managed ScaleState reports its §3.3 statistic and whether
    it sits inside the policy's target band."""
    from ..obs.counters import fraction
    health = {"grad_edge": {"sat_fraction": fraction(sat[0], sat[1]),
                            "saturated": sat[0], "total": sat[1]}}
    for site, st in scales.items():
        health.setdefault(site, {})
        health[site]["scale_log2"] = st.log2.float()
        health[site]["mean_abs"] = st.mean_abs
        health[site]["in_band"] = ((st.mean_abs >= policy.target_lo)
                                   & (st.mean_abs <= policy.target_hi)
                                   ).float()
    return health


def _ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with label >= 0, in f32."""
    logits = logits.float()
    labels = labels.long()
    mask = (labels >= 0).float()
    lab = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    ce = (logz - gold) * mask
    return torch.sum(ce) / torch.clamp(torch.sum(mask), min=1.0)


def make_loss_fn(lm: LMDef, plan, tcfg: TrainConfig):
    """``loss_fn(params, batch, scales=None) -> (loss, (metrics, obs))``:
    CE mean plus the rank prior scaled per token (Eq. 1); with a managed
    scale tree the forward runs the ``activation`` edges and ``obs``
    carries their statistic. ``batch``: ``{"tokens", "labels"}`` (B, S)
    integer tensors on the params' device; an audio model takes
    ``{"frames", "labels"}`` (frames (B, S, D) in place of the token
    embeddings), a vision model ``{"patches", "tokens", "labels"}``
    (patches (B, P, D) before the tokens; the loss on the text positions
    only)."""
    _no_mesh(plan)
    cfg = lm.cfg

    def loss_fn(params, batch, scales=None):
        if cfg.frontend == "audio":
            kwargs = {"embeds": batch["frames"]}
        elif cfg.frontend == "vision":
            kwargs = {"embeds": batch["patches"], "tokens": batch["tokens"]}
        else:
            kwargs = {"tokens": batch["tokens"]}
        if scales is not None:
            logits, aux, _, obs = lm_forward(params, lm, scales=scales,
                                             **kwargs)
        else:
            logits, aux, _ = lm_forward(params, lm, **kwargs)
            obs = {}
        labels = batch["labels"]
        if cfg.frontend == "vision":
            # the loss on the text positions only (the last len(labels))
            logits = logits[:, -labels.shape[1]:]
        ce = _ce_loss(logits, labels)
        loss = ce + cfg.moe.router_aux_coef * aux
        prior = torch.zeros((), dtype=torch.float32, device=ce.device)
        if cfg.tt.enable and cfg.tt.rank_adapt:
            # Eq. (1): CE mean + prior, the prior scaled per token so its
            # gradient pressure does not depend on the batch size
            denom = float(labels.shape[0] * labels.shape[1]) \
                * tcfg.total_steps
            prior = lm_prior_loss(params, lm) / denom
        metrics = {"ce": ce.detach(), "aux": aux.detach(),
                   "prior": prior.detach()}
        return loss + prior, (metrics, obs)

    return loss_fn


def _value_and_grad(loss_fn, params, batch, scales):
    """JAX's ``value_and_grad(..., allow_int=True)`` on the port's tree:
    (loss, aux, grads), a gradient for every floating leaf (zeros where the
    loss does not reach it, as λ behind its stop-gradients) and None for
    the integer leaves."""
    flat = flatten_with_path(params)
    live = [leaf.detach().requires_grad_() if _is_float(leaf) else leaf
            for _, leaf in flat]
    loss, aux = loss_fn(unflatten(params, live), batch, scales)
    wanted = [t for t in live if _is_float(t)]
    got = iter(torch.autograd.grad(loss, wanted, allow_unused=True))
    grads = []
    for t in live:
        if not _is_float(t):
            grads.append(None)
            continue
        g = next(got)
        grads.append(torch.zeros_like(t) if g is None else g)
    return loss.detach(), aux, unflatten(params, grads)


def _finish_step(state: TrainState, lm: LMDef, tcfg: TrainConfig,
                 policy: NumericsPolicy, grads, scales, metrics: dict):
    """Everything after the gradients: the wire, the grad edge, clipping,
    AdamW and the λ update; with ``policy.health`` (and quantization on)
    ``metrics["health"]`` from the grad edge's counts and the scales after
    it. Returns (params, opt, residual, scales, gnorm, lr)."""
    residual = state.residual
    if tcfg.grad_compress:
        from ..optim.grad_compress import compress_decompress
        grads, residual = compress_decompress(grads, residual,
                                              policy.spec_for("dp_wire"))
    want_health = policy.health and policy.enable and scales is not None
    sat = (torch.zeros(2, dtype=torch.int64, device=state.step.device)
           if want_health else None)
    grads, scales = _quantize_grad_edge(grads, scales, policy, sat)
    if want_health:
        metrics["health"] = _train_health(sat, scales, policy)
    if tcfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=state.step.device)
    lr = lr_at(state.step, tcfg)
    params, opt = adam_update(state.params, grads, state.opt, lr, tcfg)
    # closed-form Eq. (4) rank-hyperparameter update (no-op if TT is off)
    params = lm_lambda_update(params, lm)
    return params, opt, residual, scales, gnorm, lr


def make_train_step(lm: LMDef, plan, tcfg: TrainConfig):
    """``step(state, batch) -> (state, metrics)``; ``plan`` must be None
    (or carry no mesh). Metrics: ce, aux, prior, loss, gnorm, lr, device
    scalars."""
    _no_mesh(plan)
    loss_fn = make_loss_fn(lm, plan, tcfg)
    policy = lm.cfg.quant.policy()

    def train_step(state: TrainState, batch):
        loss, (metrics, obs), grads = _value_and_grad(
            loss_fn, state.params, batch, state.scales)
        scales = state.scales
        if scales is not None and obs:
            # §3.3 activation scale manager: advance on the forward's
            # observed mean |activation| (lm_forward's edges)
            scales = policy.update_scales(scales, obs)
        params, opt, residual, scales, gnorm, lr = _finish_step(
            state, lm, tcfg, policy, grads, scales, metrics)
        metrics = dict(metrics, loss=loss, gnorm=gnorm, lr=lr)
        return TrainState(params, opt, state.step + 1, residual,
                          scales), metrics

    return train_step


def make_grad_accum_train_step(lm: LMDef, plan, tcfg: TrainConfig,
                               n_micro: int):
    """Gradient accumulation: every batch leaf leads with ``n_micro``.
    Identical to ``make_train_step`` after the gradient average: the wire,
    the grad edge and clipping apply to the mean gradient, and the
    activation statistic is the micro-batches' mean. As in the reference,
    a state whose scales hold ``activation`` advances it whenever
    quantization is on, on a zero statistic where no forward ran an
    edge."""
    _no_mesh(plan)
    loss_fn = make_loss_fn(lm, plan, tcfg)
    policy = lm.cfg.quant.policy()

    def train_step(state: TrainState, batch):
        gsum = lsum = osum = None
        for k in range(n_micro):
            mb = {name: v[k] for name, v in batch.items()}
            loss, (_, obs), g = _value_and_grad(loss_fn, state.params, mb,
                                                state.scales)
            flat = flatten_with_path(g)
            g32 = [x.float() if _is_float(x) else None for _, x in flat]
            gsum = g32 if gsum is None else [
                a if b is None else a + b for a, b in zip(gsum, g32)]
            lsum = loss if lsum is None else lsum + loss
            if "activation" in obs:
                osum = obs["activation"] if osum is None \
                    else osum + obs["activation"]
        grads = unflatten(state.params, [None if g is None else g / n_micro
                                         for g in gsum])
        if osum is None:
            # no micro-batch ran an edge: the reference's scan still
            # advances the scale, on its (1,) zero start
            osum = torch.zeros((1,), device=state.step.device)
        scales = state.scales
        if scales is not None and "activation" in scales \
                and lm.cfg.quant.enable:
            scales = policy.update_scales(
                scales, {"activation": osum / n_micro})
        metrics = {}
        params, opt, residual, scales, gnorm, lr = _finish_step(
            state, lm, tcfg, policy, grads, scales, metrics)
        metrics.update(loss=lsum / n_micro, gnorm=gnorm, lr=lr)
        return TrainState(params, opt, state.step + 1, residual,
                          scales), metrics

    return train_step


def launches_per_step(lm: LMDef, tcfg: TrainConfig,
                      params=None) -> dict[str, int]:
    """Kernel launches of one ``make_train_step(lm, None, tcfg)`` step on
    the card, from the config (``params`` gives the leaf dtypes; without it
    they follow the config: cores and dense weights in ``cfg.dtype``,
    norm scales and λ in f32):

    - ``pe1`` / ``pe2`` / ``pe3``: per TT site and layer, one forward chain
      (one PE1, d-1 PE2), again in the backward when ``remat="full"``
      recomputes the layer, the transposed dx chain, and one PE3; a TT
      head the same once (it is outside the per-layer remat); a TT
      embedding none (its lookup contracts core slices eagerly).
    - ``pe1_grouped`` / ``pe2_grouped`` / ``pe3_grouped``: a TT expert
      site's (E experts stacked) the same chains, each launch grouped over
      the experts, and one PE3 a window of ``ttm.what_windows``.
    - ``p2_fq_rows``: per TT expert site, layer and forward, one launch a
      core (its E steps).
    - ``p2_fake_quant``: per TT site and layer one group launch of its
      cores per forward (two with remat), one for a TT embedding's and one
      for a TT head's cores; with the ``activation`` site,
      the embedding's edge forward and backward (forward only under the
      audio frontend: its frames need no gradient) and each sublayer's
      edge (every sublayer of a period, in every period) forward, its
      recompute and its backward; the grad edge, one group
      launch per dtype of the floating gradients and ``FQ_CAP`` of them.
    - ``bw_dec`` / ``bw_enc`` (int8 moments): m and v of every Adam leaf in
      groups of ``BW_CAP``; (the wire) one entry per reference leaf, the
      per-layer tensors of a stacked leaf flattened together."""
    cfg = lm.cfg
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"remat {cfg.remat!r} is not ported")
    fwd = 2 if cfg.remat == "full" else 1
    layers = lm.n_periods
    out = {"pe1": 0, "pe2": 0, "pe3": 0, "pe1_grouped": 0, "pe2_grouped": 0,
           "pe3_grouped": 0, "p2_fake_quant": 0, "p2_fq_rows": 0, "bw_dec": 0,
           "bw_enc": 0}
    for path, site in _walk_sites(lm):
        if not site.use_tt:
            continue
        if path[0] == "embed":
            # the lookup contracts the selected core slices eagerly (no PE
            # launch) outside the per-layer remat: one core group a step
            out["p2_fake_quant"] += int(cfg.quant.enable)
            continue
        # a layer site in every layer, recomputed under remat; the head
        # once, outside the per-layer remat
        n, f = (layers, fwd) if path[0] == "layers" else (1, 1)
        d = site.spec.d
        if site.family == "expert":
            # E experts stacked: each chain launch serves them all, Ŵ a
            # window of experts a PE3 launch, the cores one row fake-quant
            # launch each (a step an expert; one expert: a scalar step)
            e = cfg.moe.num_experts
            out["pe1_grouped"] += n * (f + 1)
            out["pe2_grouped"] += n * (f + 1) * (d - 1)
            out["pe3_grouped"] += n * len(what_windows(site.spec, e))
            if cfg.quant.enable:
                out["p2_fq_rows" if e > 1 else "p2_fake_quant"] += n * f * d
            continue
        out["pe1"] += n * (f + 1)
        out["pe2"] += n * (f + 1) * (d - 1)
        out["pe3"] += n
        if cfg.quant.enable:
            out["p2_fake_quant"] += n * f
    if params is None:
        params = init_lm(None, lm, device="meta")
    floats = [(p, leaf.dtype) for p, leaf in flatten_with_path(params)
              if leaf.is_floating_point()]
    if cfg.quant.policy().enable:
        first = 1 if cfg.frontend == "audio" else 2
        out["p2_fake_quant"] += first + layers * len(lm.period) * (fwd + 1)
        for dt in {dt for _, dt in floats}:
            n = sum(1 for _, d in floats if d == dt)
            out["p2_fake_quant"] += len(G.chunks(n, G.FQ_CAP))
    if tcfg.opt_state_dtype == "int8":
        moments = 2 * sum(1 for p, _ in floats
                          if _is_adam_leaf(p, torch.zeros(())))
        out["bw_dec"] += len(G.chunks(moments, G.BW_CAP))
        out["bw_enc"] += len(G.chunks(moments, G.BW_CAP))
    if tcfg.grad_compress:
        wire = len(stacked_groups([p for p, _ in floats]))
        out["bw_dec"] += len(G.chunks(wire, G.BW_CAP))
        out["bw_enc"] += len(G.chunks(wire, G.BW_CAP))
    return {k: v for k, v in out.items() if v}


def step_flops(lm: LMDef, batch: int, seq: int) -> float:
    """FLOPs of the TT chains of one step (forward, remat recompute, dx
    chain; ``ttm_flops_matvec``) plus PE3's Ŵ, as the launches count them:
    a layer site in every layer, recomputed under remat; the head once;
    the embedding none (its lookup launches no chain); an expert site at
    the capacity's rows for each of its E experts."""
    from ..core.ttm import ttm_flops_matvec
    from ..models.moe import _capacity
    cfg = lm.cfg
    fwd = 2 if cfg.remat == "full" else 1
    total = 0.0
    for path, site in _walk_sites(lm):
        if not site.use_tt or path[0] == "embed":
            continue
        s = site.spec
        rows, groups = batch * seq, 1
        if site.family == "expert":
            moe = next(p.ffn for p in lm.period if p.ffn_kind == "moe")
            rows, groups = _capacity(rows, moe), moe.num_experts
        n, f = (lm.n_periods, fwd) if path[0] == "layers" else (1, 1)
        total += n * groups * (f * ttm_flops_matvec(s, rows)
                               + ttm_flops_matvec(s.transposed(), rows)
                               + 2.0 * rows * s.out_dim * s.in_dim)
    return total


# ---------------------------------------------------------------------------
# the reference's checkpoint layout of a TrainState
# ---------------------------------------------------------------------------

def _stack_params(node):
    """The reference's tree of a params node: a list of per-layer trees
    becomes one tree of ``Stacked`` leaves (layer order)."""
    if isinstance(node, dict):
        return {k: _stack_params(v) for k, v in node.items()}
    if isinstance(node, list):
        flats = [flatten_with_path(item) for item in node]
        paths = [p for p, _ in flats[0]]
        if any([p for p, _ in f] != paths for f in flats):
            raise ValueError("layers of different structure cannot stack")
        return unflatten(node[0], [Stacked([f[i][1] for f in flats])
                                   for i in range(len(paths))])
    return node


def _unstack_params(like, loaded):
    """``_stack_params``'s inverse on a loaded tree: row l of each stacked
    tensor is layer l's leaf (a view)."""
    if isinstance(like, dict):
        return {k: _unstack_params(v, loaded[k]) for k, v in like.items()}
    if isinstance(like, list):
        rows = [leaf for _, leaf in flatten_with_path(loaded)]
        return [unflatten(item, [r[i] for r in rows])
                for i, item in enumerate(like)]
    return loaded


def _stack_seq(seq, paths: list[str]):
    """A moment or residual tuple over the port's leaves (``paths``) -> the
    reference's, over its stacked leaves: a group of per-layer entries
    becomes one ``Stacked`` entry (a ``QTensor``'s codes and steps each
    stacked, its shape led by the layer count)."""
    if seq is None:
        return None
    out = []
    for group in stacked_groups(paths):
        items = [seq[i] for i in group]
        if not paths[group[0]].startswith("layers/") or items[0] is None:
            out.append(items[0])
        elif isinstance(items[0], QTensor):
            q = items[0]
            out.append(QTensor(Stacked([t.codes for t in items]),
                               Stacked([t.scale for t in items]), q.spec,
                               (len(items),) + tuple(q.shape)))
        else:
            out.append(Stacked(items))
    return tuple(out)


def _unstack_seq(like, loaded, paths: list[str]):
    """``_stack_seq``'s inverse: each loaded stacked entry back to its
    per-layer entries (views of its rows), in the port's order."""
    if like is None:
        return None
    out = list(like)
    for group, node in zip(stacked_groups(paths), loaded):
        if not paths[group[0]].startswith("layers/"):
            out[group[0]] = node
            continue
        for row, i in enumerate(group):
            if node is None:
                out[i] = None
            elif isinstance(node, QTensor):
                out[i] = QTensor(node.codes[row], node.scale[row],
                                 like[i].spec, like[i].shape)
            else:
                out[i] = node[row]
    return tuple(out)


def stack_state(state: TrainState) -> TrainState:
    """``state`` in the reference's checkpoint layout: every per-layer leaf
    of ``params["layers"]`` a ``ckpt.Stacked`` of its layers (the
    reference's stacked leaf), the moments and the wire residual over the
    reference's leaves. ``ckpt.save`` / ``AsyncCheckpointer.save`` of it
    write the reference's keys, shapes and order (stacking on the host as
    they copy); no tensor is copied here."""
    paths = [p for p, _ in flatten_with_path(state.params)]
    opt = state.opt
    return TrainState(_stack_params(state.params),
                      type(opt)(opt.step, _stack_seq(opt.m, paths),
                                _stack_seq(opt.v, paths)),
                      state.step, _stack_seq(state.residual, paths),
                      state.scales)


def load_state(path: str, like: TrainState) -> tuple[TrainState, dict]:
    """A TrainState checkpoint in the reference's layout (``stack_state``:
    either package's train loop writes it) restored into ``like``'s
    structure, dtypes and device, each layer's leaf a view of its row of
    the loaded stack; returns (state, meta)."""
    loaded, meta = load(path, like=stack_state(like))
    paths = [p for p, _ in flatten_with_path(like.params)]
    opt = loaded.opt
    return TrainState(_unstack_params(like.params, loaded.params),
                      type(opt)(opt.step,
                                _unstack_seq(like.opt.m, opt.m, paths),
                                _unstack_seq(like.opt.v, opt.v, paths)),
                      loaded.step,
                      _unstack_seq(like.residual, loaded.residual, paths),
                      loaded.scales), meta
