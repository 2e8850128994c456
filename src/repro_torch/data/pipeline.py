"""Deterministic, stateless-resume synthetic token pipeline (own numpy
copy of ``repro/data/pipeline.py``: ``batch_at`` gives the same arrays,
bit for bit).

Design goals for thousand-node training:
  * **Stateless indexing** — ``batch_at(step)`` is a pure function of
    (seed, step), so restart-after-failure resumes mid-epoch exactly,
    with no iterator state in the checkpoint beyond the step counter.
  * **Per-host sharding** — each host materializes only its slice of the
    global batch (``host_batch_at``); slices concatenate to the global
    batch in host-id order, independent of host count (elastic rescale
    keeps the data order).
  * **Packing** — documents of Zipf-ish lengths packed into fixed
    ``seq_len`` rows with EOS separators and −100 label masking across
    document boundaries, mimicking a production LM mixture.
  * **Prefetch** — a double-buffering background thread hides host-side
    generation behind device compute.

The generator is a counter-based hash (SplitMix64-style) — no sequential
RNG state anywhere.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["PipelineConfig", "TokenPipeline", "Prefetcher", "pipeline_for_arch"]

_MASK64 = (1 << 64) - 1


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized SplitMix64 over uint64 counters."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(_MASK64)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(_MASK64)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(_MASK64)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 512
    pack: bool = True
    # modality stubs
    embeds_dim: int = 0         # >0 → emit frame embeddings (audio)
    media_tokens: int = 0       # >0 → emit patch embeddings (vlm)
    d_model: int = 0


class TokenPipeline:
    """Synthetic LM data with next-token labels."""

    def __init__(self, cfg: PipelineConfig):
        if cfg.vocab_size < 2:
            raise ValueError("vocab_size must be ≥ 2")
        self.cfg = cfg

    # -- core --------------------------------------------------------
    @property
    def _bigram(self) -> np.ndarray:
        """Deterministic vocabulary permutation — the learnable structure.

        The stream is a Markov chain: with prob 3/4 the next token is
        ``perm[current]``, else uniform noise. A model that learns the
        256…152k-entry bigram map reaches CE ≈ H(noise) ≪ ln(V); pure
        hash noise would be unlearnable and make convergence tests
        meaningless."""
        if not hasattr(self, "_bigram_cache"):
            rng = np.random.RandomState(self.cfg.seed ^ 0x5bd1e995)
            self._bigram_cache = rng.permutation(self.cfg.vocab_size)
        return self._bigram_cache

    def _tokens(self, step: int, rows: np.ndarray) -> np.ndarray:
        """(len(rows), seq_len+1) tokens for global row indices."""
        c = self.cfg
        S = c.seq_len + 1
        ctr = ((c.seed << 32) ^ step) & _MASK64
        ctr_mix = np.uint64((ctr * 0x9E3779B97F4A7C15) & _MASK64)
        base = (rows.astype(np.uint64)[:, None] * np.uint64(1 << 20)
                + np.arange(S, dtype=np.uint64)[None, :])
        h = _splitmix64(base ^ ctr_mix)
        noise = (h % np.uint64(c.vocab_size - 1)).astype(np.int64) + 1
        use_noise = ((h >> np.uint64(40)) % np.uint64(4)) == 0  # 25%
        perm = self._bigram
        toks = np.empty_like(noise)
        toks[:, 0] = noise[:, 0]
        for t in range(1, S):  # stateless: everything derives from (seed, step)
            nxt = perm[toks[:, t - 1]]
            toks[:, t] = np.where(use_noise[:, t], noise[:, t], nxt)
        if not c.pack:
            return toks
        # deterministic doc boundaries: EOS roughly every mean_doc_len
        hb = _splitmix64(base ^ np.uint64(0xD1B54A32D192ED03) ^ ctr_mix)
        is_eos = (hb % np.uint64(c.mean_doc_len)) == 0
        toks[is_eos] = c.eos_id
        return toks

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rows = np.arange(self.cfg.global_batch, dtype=np.int64)
        return self._assemble(step, rows)

    def host_batch_at(self, step: int, host_id: int,
                      num_hosts: int) -> dict[str, np.ndarray]:
        gb = self.cfg.global_batch
        if gb % num_hosts:
            raise ValueError(f"global_batch {gb} % hosts {num_hosts} != 0")
        per = gb // num_hosts
        rows = np.arange(host_id * per, (host_id + 1) * per, dtype=np.int64)
        return self._assemble(step, rows)

    def _assemble(self, step: int, rows: np.ndarray) -> dict[str, np.ndarray]:
        c = self.cfg
        toks = self._tokens(step, rows)
        batch: dict[str, np.ndarray] = {}
        labels = toks[:, 1:].copy()
        if c.pack:
            # don't predict across document boundaries
            labels[toks[:, 1:] == c.eos_id] = -100
        batch["labels"] = labels.astype(np.int32)
        if c.embeds_dim:
            # audio stub: frame embeddings instead of tokens
            ctr = np.uint64(c.seed * 1315423911 + step)
            h = _splitmix64(
                (rows.astype(np.uint64)[:, None, None] * np.uint64(1 << 40))
                + (np.arange(c.seq_len, dtype=np.uint64)[None, :, None]
                   << np.uint64(16))
                + np.arange(c.embeds_dim, dtype=np.uint64)[None, None, :]
                ^ ctr)
            batch["embeds"] = ((h >> np.uint64(40)).astype(np.float32)
                               / (1 << 24) - 0.5)
        else:
            batch["tokens"] = toks[:, :-1].astype(np.int32)
        if c.media_tokens:
            ctr = np.uint64(c.seed * 2654435761 + step)
            h = _splitmix64(
                (rows.astype(np.uint64)[:, None, None] * np.uint64(1 << 40))
                + (np.arange(c.media_tokens, dtype=np.uint64)[None, :, None]
                   << np.uint64(16))
                + np.arange(c.d_model, dtype=np.uint64)[None, None, :]
                ^ ctr)
            batch["media"] = ((h >> np.uint64(40)).astype(np.float32)
                              / (1 << 24) - 0.5)
        return batch

    def iter_from(self, step: int) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Double-buffering background producer over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)
            self._q.put(None)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass



def pipeline_for_arch(arch_cfg, shape, seed: int = 0) -> TokenPipeline:
    """Pipeline matching an (ArchConfig, ShapeSpec) cell: frame embeddings
    for an ``embeds_input`` arch, patch embeddings (``media``) for a VLM."""
    return TokenPipeline(PipelineConfig(
        vocab_size=arch_cfg.vocab_size,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        seed=seed,
        embeds_dim=arch_cfg.d_model if arch_cfg.embeds_input else 0,
        media_tokens=arch_cfg.num_media_tokens,
        d_model=arch_cfg.d_model,
    ))
