"""The split program's parts every LM family shares (the transformer, the
hybrid and RWKV): the vocab-parallel embedding, head, logits and cross
entropy, the positions, the last row, and a layer run under remat.

Each takes a data group's ``repro_torch.sharding.split.Split`` and the
placed parameter tree (``Sharded`` leaves in the JAX layout; the head is
``lm_head`` where the tree has one, else the tied embedding's rows)."""

from __future__ import annotations

import torch

from repro_torch.models import common

CE_CHUNK = 512  # the cross entropy's logits block along the sequence


def positions(sp) -> list:
    """(S,) positions on every computed device."""
    return sp.parts(lambda m: torch.arange(sp.seq_len, device=sp.devices[m]))


def embed(sp, tree, tokens: list):
    """The split lookup of ``tokens`` (one copy a device): vocab rows on
    `model`, each device's rows looked up where its slice holds them (zeros
    elsewhere), summed over shards (into ``sp.layout``); a vocab `fit` leaves
    whole: each device looks up its own rows."""
    w = sp.weights({"embed": tree["embed"]}, "embed").embed
    if w.model_dim == 0:
        def lookup(tok, m):
            vm = w[m].shape[0]
            local = tok - m * vm
            inside = (local >= 0) & (local < vm)
            e = w[m][torch.clamp(local, 0, vm - 1)]
            return torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype,
                                                                  device=e.device))
        return sp.to(sp.dist(sp.PARTIAL, sp.parts(lambda m: lookup(tokens[m], m))), sp.layout)
    return sp.to(sp.dist(sp.ROWS, sp.parts(lambda m: w[m][
        tokens[m].narrow(1, sp.row_start[m], sp.rows[m])])), sp.layout)


def head(sp, tree):
    """The head's gathered weight (d, V): vocab-parallel where the specs
    split V (tied: the embedding's rows)."""
    if "lm_head" not in tree:
        return sp.weights({"embed": tree["embed"]}, "head").embed.T
    return sp.weights({"lm_head": tree["lm_head"]}, "head").lm_head


def logits(sp, tree, h) -> torch.Tensor:
    """One token's logits (B, V) float32 on ``sp.root`` from its final
    hidden ``h`` (B, 1, d) ``FULL``: each device its vocab columns,
    gathered to the root (a vocab `fit` leaves whole: the root's product)."""
    w = head(sp, tree)
    if w.model_dim is None:
        return (h.parts[sp.root] @ w[sp.root]).float()[:, 0]
    return sp.to_root(sp.mm(h, w).map(lambda t, m: t.float()))[:, 0]


def last(sp, h):
    """The last position's row (B, 1, d) of a hidden in ``sp.layout``,
    ``FULL``: in ``ROWS`` it is the last device's, all-gathered."""
    if h.kind == sp.FULL or sp.M == 1:
        return sp.dist(sp.FULL, h.map(lambda t, m: t[:, -1:]).parts)
    tail = h.map(lambda t, m: t[:, -1:] if m == sp.M - 1 else t[:, :0])
    return sp.to(sp.dist(sp.ROWS, tail.parts), sp.FULL, sizes=[0] * (sp.M - 1) + [1])


def cross_entropy(sp, tree, hidden, labels: list, mask: torch.Tensor | None = None):
    """``transformer._chunked_ce`` with vocab-parallel logits: device m holds
    its vocab columns of each (B, chunk) block's logits; each chunk's
    log-sum-exp and gold logit are reduced over `model` on ``sp.root`` in
    shard order, so no device holds a (B, chunk, V) block.  ``mask`` (B, S)
    on ``sp.root``'s device."""
    w = head(sp, tree)
    root = sp.devices[sp.root]
    tot = torch.zeros((), dtype=torch.float32, device=root)
    cnt = torch.zeros((), dtype=torch.float32, device=root)
    if w.model_dim is None:  # the vocab whole on every device: its own rows
        hr = sp.to(hidden, sp.ROWS)

        def rows_sums(t, m):
            lab = labels[m].narrow(1, sp.row_start[m], sp.rows[m])
            lg = (t @ w[m]).float()
            nll = torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, lab[..., None].long())[..., 0]
            mc = (torch.ones(nll.shape, dtype=torch.float32, device=nll.device)
                  if mask is None else
                  mask.narrow(1, sp.row_start[m], sp.rows[m]).to(nll.device).float())
            return torch.stack([torch.sum(nll * mc), torch.sum(mc)])

        sums = sp.sum_to_root(hr.map(rows_sums))
        return sums[0] / torch.clamp(sums[1], min=1.0)
    hf = sp.to(hidden, sp.FULL)
    b, s = labels[sp.root].shape
    chunk = s if s <= CE_CHUNK or s % CE_CHUNK else CE_CHUNK
    for c in range(s // chunk):
        cols = slice(c * chunk, (c + 1) * chunk)

        def shard(t, m):
            lg = (t[:, cols] @ w[m]).float()
            vm = lg.shape[-1]
            local = labels[m][:, cols].long() - m * vm
            inside = (local >= 0) & (local < vm)
            gold = torch.gather(lg, -1, torch.clamp(local, 0, vm - 1)[..., None])[..., 0]
            return torch.logsumexp(lg, dim=-1), torch.where(inside, gold, 0.0)

        both = hf.map(shard)
        logz = torch.logsumexp(sp.gather_to_root(both.map(lambda t, m: t[0])), dim=0)
        gold = sp.sum_to_root(both.map(lambda t, m: t[1]))
        mc = (mask[:, cols].float() if mask is not None
              else torch.ones((b, chunk), dtype=torch.float32, device=root))
        tot = tot + torch.sum((logz - gold) * mc)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp(cnt, min=1.0)


def remat_layer(cfg, sp, x, body):
    """``body(x)`` (``x`` a ``Dist``, the result in its kind, and any extra
    outputs a tuple of tensors) under ``common.remat``: its weights gathered
    inside ``body`` are gathered again when the backward recomputes it.
    Returns (the result, the extras)."""
    active = [m for m in range(sp.M) if x.parts[m] is not None]

    def run(*parts):
        xs = [None] * sp.M
        for m, t in zip(active, parts):
            xs[m] = t
        y, extras = body(sp.dist(x.kind, xs))
        return (*[y.parts[m] for m in active], *extras)

    out = common.remat(cfg, run, *[x.parts[m] for m in active])
    ys = [None] * sp.M
    for m, t in zip(active, out[:len(active)]):
        ys[m] = t
    return sp.dist(x.kind, ys), tuple(out[len(active):])
