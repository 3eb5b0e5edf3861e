"""Self-speculative drafting for the serving engine (a copy of
``deepspeed_tpu/inference/speculation.py``, numpy only; docs/serving.md
"Speculative decoding").

Prompt-lookup / n-gram drafting (Saxena 2023, "Prompt Lookup Decoding"):
the request's OWN prompt+output token history is the draft model. If the
last ``m`` tokens of the history re-occur earlier in it, the tokens that
followed that earlier occurrence are proposed as the draft — a pure host
operation, zero extra parameters, zero device work. The verify
program (inference/serving.SlotWorker.verify) then scores the whole draft
in one forward pass; greedy requests keep bitwise parity with
non-speculative decode because the verifier only ever ACCEPTS tokens the
model would have emitted anyway.

Drafting is deliberately STATELESS: every step rebuilds its proposal from
the slot's prompt+tokens, so a Router failover / quarantine requeue that
replays the request from scratch starts with exactly the draft state a
fresh request would have — nothing to reset, nothing to double-count.

``draft_source="draft_model"`` (EXPERIMENTAL) is a host-resident tiny
draft model: a fixed random embedding + projection pair seeded from a
constant, rolled out greedily on the host. It carries no trained weights —
the point is the END-TO-END wiring (drafter protocol, verify buckets,
failover replay identity) with a draft distribution that is *cheap and
deterministic*, not *good*. Greedy parity still holds for the same reason
as ngram: the verifier, not the draft, decides every emitted token.
"""

from __future__ import annotations

import numpy as np

from ..runtime.config import SpeculationConfig

# longest history suffix the lookup tries to re-find before falling back to
# shorter ones — matches prompt-lookup practice (long matches first: they
# are rarer and their continuations far likelier to be accepted)
MAX_NGRAM = 8


class NgramDrafter:
    """Prompt-lookup drafter: propose up to ``depth`` tokens by matching the
    history's suffix n-gram against its earlier occurrences."""

    def __init__(self, cfg: SpeculationConfig):
        self.cfg = cfg

    def propose(self, history: np.ndarray, depth: int) -> np.ndarray:
        """history [S] int32 (prompt + generated so far) -> draft [k] int32,
        0 <= k <= depth. Deterministic: the LONGEST suffix match wins, ties
        broken by the MOST RECENT earlier occurrence that can supply a
        full-``depth`` continuation (recency tracks the local repetition
        structure greedy decode actually produces; the full-depth
        preference keeps loop-period matches from truncating drafts)."""
        h = np.asarray(history).reshape(-1)
        S = int(h.shape[0])
        lo = int(self.cfg.ngram_min_match)
        if depth < 1 or S < lo + 1:
            return np.zeros((0,), np.int32)
        # cheap pre-pass: if even the MINIMUM-length suffix n-gram has no
        # earlier occurrence, no longer one can — the no-match case (every
        # non-repetitive decode step) pays one windowed scan, not
        # MAX_NGRAM of them
        win = h[: S - 1]
        if win.shape[0] >= lo:
            pat = h[S - lo:]
            eq = win[: win.shape[0] - lo + 1] == pat[0]
            for j in range(1, lo):
                eq = eq & (win[j: win.shape[0] - lo + 1 + j] == pat[j])
            if not eq.any():
                return np.zeros((0,), np.int32)
        for m in range(min(MAX_NGRAM, S - 1), lo - 1, -1):
            pat = h[S - m:]
            # candidate start positions: occurrences strictly before the
            # suffix itself (a match AT the suffix is vacuous)
            win = h[: S - 1]  # ensure >= 1 continuation token exists
            if win.shape[0] < m:
                continue
            # windowed equality: starts[i] <=> h[i : i+m] == pat
            eq = win[: win.shape[0] - m + 1] == pat[0]
            for j in range(1, m):
                eq = eq & (win[j: win.shape[0] - m + 1 + j] == pat[j])
            starts = np.flatnonzero(eq)
            if starts.size == 0:
                continue
            if starts.size > 1:
                # majority vote on the FIRST continuation token: outside a
                # tight loop the history revisits a context with several
                # different continuations, and the modal one is likelier to
                # be re-emitted than whatever happened most recently. Ties
                # keep the recency rule (inside a loop every occurrence
                # continues identically, so this is a no-op there).
                nxt = h[starts + m]
                vals, cnt = np.unique(nxt, return_counts=True)
                top = vals[cnt == cnt.max()]
                best = top[0] if top.size == 1 else (
                    nxt[np.flatnonzero(np.isin(nxt, top))[-1]])
                starts = starts[nxt == best]
            # an occurrence only yields the tokens BETWEEN it and the end
            # of history, so the most recent match (which sits one loop
            # period before the suffix) caps the draft at the period. Take
            # the most recent occurrence that can fill the whole depth;
            # when none can, the earliest one has the longest continuation.
            full = starts[starts + m + depth <= S]
            i = int(full[-1]) if full.size else int(starts[0])
            cont = h[i + m: i + m + depth]
            if cont.size:
                return np.asarray(cont, np.int32)
        return np.zeros((0,), np.int32)


class DraftModelDrafter:
    """EXPERIMENTAL host-resident tiny draft model (docs/serving.md
    "Speculative decoding > draft_model").

    A fixed-seed random embedding table ``E [vocab, dim]`` and projection
    ``P [dim, vocab]`` form a degenerate one-layer language model scored
    entirely in numpy: the context vector is an exponentially-decayed mean
    of recent-token embeddings, each draft token is the argmax of
    ``ctx @ P``, and the rollout feeds its own prediction back in. Like
    the n-gram drafter it is STATELESS across steps (rebuilt from the
    slot's history every call) so failover replay produces identical
    drafts, and DETERMINISTIC (constant seed, argmax with numpy's
    first-index tie break) so greedy parity is bitwise."""

    _DIM = 16  # embedding width — big enough to spread ties, host-cheap

    def __init__(self, cfg: SpeculationConfig, vocab_size: int):
        self.cfg = cfg
        rng = np.random.default_rng(0xD5A57)  # constant: replicas agree
        self._emb = rng.standard_normal(
            (int(vocab_size), self._DIM)).astype(np.float32)
        self._proj = rng.standard_normal(
            (self._DIM, int(vocab_size))).astype(np.float32)

    def propose(self, history: np.ndarray, depth: int) -> np.ndarray:
        h = np.asarray(history).reshape(-1)
        if depth < 1 or h.shape[0] == 0:
            return np.zeros((0,), np.int32)
        # decayed mean over (up to) the last 2*DIM tokens — O(DIM^2) host
        # flops per call, independent of the full history length
        ctx = np.zeros((self._DIM,), np.float32)
        for t in h[-2 * self._DIM:]:
            ctx = 0.5 * ctx + 0.5 * self._emb[int(t)]
        out = []
        for _ in range(depth):
            nxt = int(np.argmax(ctx @ self._proj))
            out.append(nxt)
            ctx = 0.5 * ctx + 0.5 * self._emb[nxt]
        return np.asarray(out, np.int32)


def make_drafter(cfg: SpeculationConfig, vocab_size: int | None = None):
    """Drafter factory for ``serving.speculation.draft_source``."""
    if cfg.draft_source == "ngram":
        return NgramDrafter(cfg)
    if cfg.draft_source == "draft_model":
        if vocab_size is None:
            raise ValueError(
                "draft_source='draft_model' needs the model's vocab_size to "
                "build its host-resident scorer")
        return DraftModelDrafter(cfg, vocab_size)
    raise NotImplementedError(
        f"unknown serving.speculation.draft_source={cfg.draft_source!r}")
