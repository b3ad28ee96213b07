"""The all-to-all MoE: per-device routing + an explicit all-to-all dispatch
— the port of ``repro.models.moe_shardmap``.

The JAX package writes it as a ``shard_map`` over the mesh; here it is
one explicit program driven from this process, as the port's other mesh
programs, with the reference's per-device semantics (they decide which
tokens drop):

  * tokens are blocked over every mesh axis: batch over data(+pod), seq
    over `model`; each device routes its own T_dev tokens (float32
    router, the port's stable top-k, gates renormalised);
  * the aux loss is E * sum(dispatch fraction * mean probability), each
    fraction first averaged over every device (the product of the global
    means);
  * each device builds an (E, C_dev, d) send buffer, with local capacity
    C_dev = max(1, round(T_dev * k / E * cf)) and a spare row for the
    drops (GShard drop semantics per device);
  * the all-to-all over `model` is a copy of each peer's block in peer
    order: the device at model index i receives block i of every peer's
    buffer (the tokens routed to its experts), runs its E/M local experts
    (their EP blocks of the weights) on (E_loc, M * C_dev, d), and the
    inverse all-to-all returns each peer's outputs;
  * the combine is a local gather + (T_dev, k, d) reshape-sum, plus the
    replicated shared expert.

Dropping is per device here and global in ``moe_forward``, so the two
agree whenever nothing drops and differ only in which over-capacity
tokens drop.  Every step is a torch op or a device copy, so gradients
flow through it with autograd to the input and to every weight.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import check_mesh
from repro_torch.models import common
from repro_torch.models.ffn import ffn_forward
from repro_torch.models.moe import MoEParams, top_k as stable_top_k


class ShardMapMoE:
    """``moe_forward(p, x, *, top_k, capacity_factor, act)`` as the
    all-to-all program on ``mesh`` (``make_shardmap_moe``).  After a call,
    ``dropped`` holds the count of dropped (token, expert) assignments and
    ``keep`` each device's (T_dev * k,) keep mask, in mesh order."""

    def __init__(self, mesh, model_axis: str = "model"):
        self.mesh = check_mesh(mesh)
        self.model_axis = model_axis
        sizes = self.mesh.shape
        self.data_axes = tuple(a for a in ("pod", "data") if a in sizes)
        self.n_data = int(np.prod([sizes[a] for a in self.data_axes], dtype=np.int64))
        self.n_model = sizes[model_axis]
        self.dropped: torch.Tensor | None = None
        self.keep: list[torch.Tensor] = []

    def device(self, i: int, j: int) -> torch.device:
        """The device of data block i (row-major over the data axes) and
        model index j."""
        sizes = self.mesh.shape
        coords = np.unravel_index(i, [sizes[a] for a in self.data_axes]) if self.data_axes else ()
        at = {a: int(c) for a, c in zip(self.data_axes, coords)}
        at[self.model_axis] = j
        return self.mesh.device_at(at)

    def __call__(self, p: MoEParams, x: torch.Tensor, *, top_k: int,
                 capacity_factor: float = 1.25, act: str = "silu"):
        b, s, d = x.shape
        e = p.router.shape[1]
        nd, m = self.n_data, self.n_model
        if b % nd or s % m or e % m:
            raise ValueError(f"x {tuple(x.shape)} with {e} experts does not block over "
                             f"{nd} data x {m} model shards")
        bl, sl, e_loc = b // nd, s // m, e // m
        t_dev = bl * sl
        tk = t_dev * top_k
        c_dev = int(max(1, round(t_dev * top_k / e * capacity_factor)))
        a = common.act_fn(act)
        home = x.device

        # -- per-device routing and send buffers --
        dev = {}
        for i in range(nd):
            for j in range(m):
                device = self.device(i, j)
                xt = x[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl].to(device).reshape(t_dev, d)
                probs = torch.softmax(xt.float() @ p.router.to(device), dim=-1)
                gate_vals, gate_idx = stable_top_k(probs, top_k)
                gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
                flat_expert = gate_idx.reshape(tk)
                onehot = F.one_hot(flat_expert, e)
                rank = torch.cumsum(onehot, dim=0).gather(1, flat_expert[:, None])[:, 0] - 1
                keep = rank < c_dev
                dest = torch.where(keep, flat_expert * c_dev + rank,
                                   torch.full_like(rank, e * c_dev))
                flat_token = torch.arange(tk, device=device) // top_k
                buf_tok = torch.full((e * c_dev + 1,), tk, dtype=torch.int64, device=device)
                buf_tok[dest] = flat_token  # the spare row takes the drops
                buf_tok = buf_tok[: e * c_dev]
                valid = (buf_tok < tk)[:, None]
                rows = xt[torch.clamp(buf_tok, max=t_dev - 1)]
                send = torch.where(valid, rows, torch.zeros((), dtype=x.dtype, device=device))
                dev[i, j] = dict(device=device, xt=xt, probs=probs, gate_vals=gate_vals,
                                 onehot=onehot, keep=keep, dest=dest,
                                 send=send.reshape(m, e_loc, c_dev, d))

        # -- aux: the fractions averaged over every device, then the product --
        order = [dev[i, j] for i in range(nd) for j in range(m)]
        disp = sum((o["onehot"].sum(dim=0).float() / tk).to(home) for o in order) / len(order)
        prob = sum(o["probs"].mean(dim=0).to(home) for o in order) / len(order)
        aux = e * torch.sum(disp * prob)

        # -- all-to-all over `model`, the local experts, the inverse all-to-all --
        for i in range(nd):
            outs = []
            for j in range(m):  # device j's experts: block j of every peer's buffer
                me = dev[i, j]["device"]
                recv = torch.stack([dev[i, peer]["send"][j].to(me) for peer in range(m)])
                recv = recv.transpose(0, 1).reshape(e_loc, m * c_dev, d)
                sl_e = slice(j * e_loc, (j + 1) * e_loc)
                w_gate, w_up = p.w_gate[sl_e].to(me), p.w_up[sl_e].to(me)
                h = a(torch.bmm(recv, w_gate)) * torch.bmm(recv, w_up)
                out = torch.bmm(h, p.w_down[sl_e].to(me))  # (E_loc, M*C_dev, d)
                outs.append(out.reshape(e_loc, m, c_dev, d).transpose(0, 1))
            for j in range(m):  # each peer's outputs back, in peer order
                me = dev[i, j]["device"]
                back = torch.stack([outs[peer][j].to(me) for peer in range(m)])
                dev[i, j]["back"] = back.reshape(e * c_dev, d)

        # -- combine: gather + (T_dev, k, d) reshape-sum, + the shared expert --
        rows = []
        for i in range(nd):
            cols = []
            for j in range(m):
                o = dev[i, j]
                g = o["back"][torch.clamp(o["dest"], max=e * c_dev - 1)]
                g = g * (o["gate_vals"].reshape(-1) * o["keep"])[:, None].to(x.dtype)
                y = g.reshape(t_dev, top_k, d).sum(dim=1).to(home)
                if p.shared is not None:  # replicated: on the weights' device
                    y = y + ffn_forward(p.shared, o["xt"].to(home), act)
                cols.append(y.reshape(bl, sl, d))
            rows.append(torch.cat(cols, dim=1))
        self.keep = [o["keep"] for o in order]
        self.dropped = sum((~o["keep"]).sum().to(home) for o in order)
        return torch.cat(rows, dim=0), aux


def make_shardmap_moe(mesh, *, model_axis: str = "model") -> ShardMapMoE:
    """Returns moe_forward(p, x, *, top_k, capacity_factor, act) drop-in
    (``moe.set_impl`` installs it).

    x is (B, S, d), blocked with batch over the data axes and seq over
    `model` — the activation_sharder layout; the expert weights split
    over `model` (EP), the router and the shared expert replicated."""
    return ShardMapMoE(mesh, model_axis)
