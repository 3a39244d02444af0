"""Secure aggregation by pairwise antisymmetric PRG masks, drawn on the
parameters' device.

Counterpart of ``qfedx_tpu/fed/secure_agg.py`` (``client_mask``,
``ring_mask``): for each masked pair of this round's cohort one end adds
+m and the other −m, so the server's sum of masked updates equals the
sum of the raw ones while no single update travels in the clear. The
pair graphs, signs, scale and degenerate cases are the reference's:

- ``ring_mask`` (the default): each participant pairs with its ``k``
  cyclic successors in the cohort ordered by client id; the directed
  edge (src → succ_d(src)) at hop d adds +m at its source and −m at its
  destination. A self-edge (a cohort no larger than the hop) has
  coefficient 0, so cohorts of 0 or 1 get no mask.
- ``client_mask``: the complete graph, the lower id of each pair adding
  +m and the higher −m.

The stream of a mask is its own ``torch.Generator``, seeded from (round
seed, src, dst, hop) for a ring edge and from (round seed, min, max) for
a pair, so both ends derive it with no exchange — the port's form of the
reference's ``fold_in`` of a replicated round key. jax.random cannot be
reproduced in torch, so the port's masks are other numbers than the
reference's; the graph and the cancellation are the same.

``wave_masks`` draws the masks of the cohort positions ``[base, base +
W)`` of one wave under the cohort's pair graph: only the edges that
touch the wave (O(W·k) on the ring), one draw per edge, then two
``index_add_``. ``fed/round.py`` adds it to the wave's weighted
contributions, so ring masks whose partners live in other waves cancel
in the cross-wave sum; ``cohort_masks`` is the one-wave case.
``unmatched_mask_sum`` is the server's correction for participants that
never reported (a wave whose fetch died): their masks, regenerated from
the same seeds, summed.
"""

from __future__ import annotations

import numpy as np
import torch

from qfedx_tpu_torch.utils import trees

# Tags that keep the ring's and the complete graph's streams apart.
_RING, _PAIR = 1, 2


def round_seed(seed: int, round_idx: int, salt: int) -> int:
    """The secure-agg seed of round ``round_idx``: a function of
    (seed, round, salt) alone, so a resumed run draws the same masks."""
    return int(np.random.SeedSequence([seed, round_idx, salt])
               .generate_state(1, np.uint64)[0] >> 1)


def edge_seed(seed: int, src: int, dst: int, hop: int) -> int:
    """Seed of the directed ring edge src → dst at hop distance ``hop``."""
    return int(np.random.SeedSequence([seed, _RING, src, dst, hop])
               .generate_state(1, np.uint64)[0] >> 1)


def pair_seed(seed: int, i: int, j: int) -> int:
    """Seed of the unordered pair {i, j}: both ends agree."""
    lo, hi = min(i, j), max(i, j)
    return int(np.random.SeedSequence([seed, _PAIR, lo, hi])
               .generate_state(1, np.uint64)[0] >> 1)


def _participants(participation) -> np.ndarray:
    return np.flatnonzero(np.asarray(participation) > 0)


def _touches(ends: np.ndarray, touching) -> np.ndarray:
    """0/1 per entry of ``ends``: is the client in ``touching`` (a
    ``range`` or an array of ids; None means every client)?"""
    if touching is None:
        return np.ones(len(ends), bool)
    if isinstance(touching, range):
        return (ends >= touching.start) & (ends < touching.stop)
    return np.isin(ends, np.asarray(touching))


def ring_edges(seed: int, participation, neighbors: int = 1,
               touching=None) -> list:
    """(src, dst, hop, stream seed) of every ring edge: each participant
    and its ``neighbors`` cyclic successors among the participants in id
    order; self-edges dropped. With ``touching`` (a range or ids), only
    the edges with an end there, in the same order, and only their
    stream seeds computed."""
    members = _participants(participation)
    m = len(members)
    out = []
    for d in range(1, neighbors + 1):
        if m == 0:
            break
        dsts = members[(np.arange(m) + d) % m]
        keep = (dsts != members) & (_touches(members, touching)
                                    | _touches(dsts, touching))
        for src, dst in zip(members[keep], dsts[keep]):
            out.append((int(src), int(dst), d,
                        edge_seed(seed, int(src), int(dst), d)))
    return out


def pair_edges(seed: int, participation, touching=None) -> list:
    """(lo, hi, stream seed) of every pair of participants, lo < hi
    (with ``touching``, only the pairs with an end there)."""
    members = _participants(participation)
    inside = _touches(members, touching)
    return [(int(i), int(j), pair_seed(seed, int(i), int(j)))
            for a, i in enumerate(members) for b, j in
            enumerate(members[a + 1:], a + 1) if inside[a] or inside[b]]


def _edges(seed, participation, mode: str, neighbors: int,
           touching=None) -> list:
    if mode == "ring":
        return ring_edges(seed, participation, neighbors, touching)
    if mode == "pairwise":
        return pair_edges(seed, participation, touching)
    raise ValueError(f"unknown secure_agg_mode {mode!r}")


def _draw(edges: list, size: int, device) -> torch.Tensor:
    """(E, size) f32: row e is N(0,1) from edge e's own generator (its
    seed is the edge's last entry)."""
    out = torch.empty((len(edges), size), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    for e, edge in enumerate(edges):
        gen.manual_seed(edge[-1])
        torch.randn(size, generator=gen, out=out[e])
    return out


def _unflat(flat: torch.Tensor, template, lead: tuple):
    """Split the last axis of ``flat`` into ``template``'s leaves (their
    own shapes after ``lead``)."""
    leaves = trees.tree_leaves(template)
    shapes = [tuple(x.shape[len(lead):]) for x in leaves]
    parts = iter(torch.split(flat, [int(np.prod(s)) for s in shapes],
                             dim=-1))
    return trees.tree_map(
        lambda x: next(parts).reshape(lead + tuple(x.shape[len(lead):])),
        template,
    )


def wave_masks(seed: int, template, participation, base: int = 0,
               scale: float = 1.0, mode: str = "ring",
               neighbors: int = 1):
    """The masks of cohort positions ``[base, base + W)``: ``template``
    has (W, …) leaves (the wave's stacked client updates),
    ``participation`` [cohort] 0/1 the pair graph's members → a tree of
    (W, …) masks. Each client's mask is the one it has under the cohort's
    whole graph, so the masks of all waves sum to zero over the cohort;
    non-participants get zeros."""
    leaves = trees.tree_leaves(template)
    width = leaves[0].shape[0]
    device = leaves[0].device
    size = sum(int(np.prod(x.shape[1:])) for x in leaves)
    edges = _edges(seed, participation, mode, neighbors,
                   range(base, base + width))
    flat = torch.zeros((width, size), dtype=torch.float32, device=device)
    if edges:
        draws = _draw(edges, size, device) * scale
        for end, sign in ((0, 1.0), (1, -1.0)):
            rows = np.asarray([e[end] for e in edges]) - base
            inside = np.flatnonzero((rows >= 0) & (rows < width))
            if len(inside) == 0:
                continue
            sel = draws if len(inside) == len(edges) else draws[
                torch.as_tensor(inside, device=device)]
            flat.index_add_(0, torch.as_tensor(rows[inside], device=device),
                            sel if sign > 0 else -sel)
    return _unflat(flat, template, (width,))


def cohort_masks(seed: int, template, participation, scale: float = 1.0,
                 mode: str = "ring", neighbors: int = 1):
    """Every client's mask of one round: ``template`` has (C, …) leaves
    (the stacked client updates), ``participation`` [C] 0/1 the pair
    graph's cohort → a tree of (C, …) masks that sums to zero over C.
    Non-participants get zeros."""
    return wave_masks(seed, template, participation, 0, scale, mode,
                      neighbors)


def unmatched_mask_sum(seed: int, num_clients: int, template,
                       participation, survivors, scale: float = 1.0,
                       neighbors: int = 1, mode: str = "ring"):
    """Σ over participants that did not survive of their masks, shaped
    like ``template`` (no client axis): the server's regenerated
    correction for mid-round casualties. The survivors' uploads carry
    −Σ_dead m_j of unmatched mask (the whole graph cancels), so adding
    this sum back leaves only float dust; only dead clients' masks are
    rebuilt, from the same stream seeds."""
    _check(participation, num_clients)
    part = np.asarray(participation, np.float32)
    dead = np.flatnonzero((part > 0) & (np.asarray(survivors) <= 0))
    leaves = trees.tree_leaves(template)
    device = leaves[0].device
    size = sum(x.numel() for x in leaves)
    acc = torch.zeros(size, dtype=torch.float32, device=device)
    edges = _edges(seed, part, mode, neighbors, dead) if len(dead) else []
    if edges:
        src_dead = np.isin([e[0] for e in edges], dead)
        dst_dead = np.isin([e[1] for e in edges], dead)
        coeff = torch.as_tensor(src_dead.astype(np.float32)
                                - dst_dead.astype(np.float32), device=device)
        acc = (coeff[:, None] * _draw(edges, size, device)).sum(0) * scale
    return _unflat(acc, template, ())


def _one_mask(seed, client_id: int, template, participation, scale, mode,
              neighbors):
    leaves = trees.tree_leaves(template)
    device = leaves[0].device
    size = sum(x.numel() for x in leaves)
    mine = _edges(seed, participation, mode, neighbors,
                  range(client_id, client_id + 1))
    acc = torch.zeros(size, dtype=torch.float32, device=device)
    if mine:
        signs = torch.as_tensor(
            [1.0 if e[0] == client_id else -1.0 for e in mine],
            device=device)
        acc = (signs[:, None] * _draw(mine, size, device)).sum(0) * scale
    return _unflat(acc, template, ())


def client_mask(seed: int, client_id: int, num_clients: int, template,
                participation, scale: float = 1.0):
    """Σ_j sign(j − i)·1[both participate]·PRG(pair(i, j)) shaped like
    ``template``: client ``client_id``'s mask on the complete graph."""
    _check(participation, num_clients)
    return _one_mask(seed, client_id, template, participation, scale,
                     "pairwise", 1)


def ring_mask(seed: int, client_id: int, num_clients: int, template,
              participation, scale: float = 1.0, neighbors: int = 1):
    """Client ``client_id``'s ring mask: +PRG on its edges to its
    ``neighbors`` successors, −PRG on the edges from its predecessors."""
    _check(participation, num_clients)
    return _one_mask(seed, client_id, template, participation, scale,
                     "ring", neighbors)


def _check(participation, num_clients: int) -> None:
    if len(participation) != num_clients:
        raise ValueError(f"participation has {len(participation)} entries "
                         f"for {num_clients} clients")
