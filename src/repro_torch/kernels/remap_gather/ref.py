"""Plain PyTorch versions of the copy engine: the gather
``out[i] = pool[idx[i]]`` and the replay of recorded page copies."""

import torch

FAST_TO_SLOW = 0      # record direction: a copy-back, fast page -> slow page
SLOW_TO_FAST = 1      # an install, slow page -> fast page


def remap_gather_ref(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return pool[idx.long()]


def remap_replay_ref(pools, recs: torch.Tensor) -> None:
    """Replay ``recs`` [n_rec, 4] (dir, src, dst, en) over ``pools`` =
    (fast_k, fast_v, slow_k, slow_v) in place, one record after another:
    an enabled record copies page ``src`` of its source pool to page
    ``dst`` of the other on every layer, K and V alike; a disabled one is
    skipped unread.  An enabled record outside its pools raises
    ``IndexError`` before anything is written.  Reads the records on the
    host (one wait on a card)."""
    fk, fv, sk, sv = pools
    rows = [r for r in recs.tolist() if r[3]]
    for d, s, t, _ in rows:
        n_src, n_dst = ((fk.shape[1], sk.shape[1]) if d == FAST_TO_SLOW
                        else (sk.shape[1], fk.shape[1]))
        if d not in (FAST_TO_SLOW, SLOW_TO_FAST) or not (
                0 <= s < n_src and 0 <= t < n_dst):
            raise IndexError(f"remap_replay: record {(d, s, t)} lies outside "
                             f"its pools")
    for d, s, t, _ in rows:
        for fast, slow in ((fk, sk), (fv, sv)):
            src, dst = (fast, slow) if d == FAST_TO_SLOW else (slow, fast)
            dst[:, t] = src[:, s]
