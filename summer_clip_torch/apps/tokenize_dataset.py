"""Corpus tokenization: text -> fixed-length CLIP-BPE token chunks.

Counterpart of ``summer_clip_tpu/apps/tokenize_dataset.py``: the output is an
(N_chunks, max_length) int32 ``.npy`` matrix (``store.save_array``) that
``train_gpt`` reads rows of straight into its batches. Sources: an HF dataset
(when the ``datasets`` library and the data are present; it is imported only
then), a directory/glob of text files, or the built-in synthetic corpus.

Run: ``python -m summer_clip_torch.apps.tokenize_dataset max_length=80
output_path=<npy>``.
"""

from __future__ import annotations

import logging
import typing as tp
from pathlib import Path

import numpy as np

from summer_clip_torch.core import config as C
from summer_clip_torch.models.tokenizer import get_tokenizer
from summer_clip_torch.store import save_array

__all__ = ["tokenize_texts", "chunk_tokens", "iter_corpus_texts", "run"]


def tokenize_texts(texts: tp.Iterable[str], tokenizer, max_length: int,
                   drop_last: bool = True) -> np.ndarray:
    """Tokenize and re-chunk a text stream into (N, max_length) rows: each
    document is tokenized and split into max_length-sized chunks; short tails
    are dropped (``drop_last``) or zero-padded."""
    rows: tp.List[np.ndarray] = []
    for text in texts:
        ids = tokenizer.encode(text)
        for s in range(0, len(ids) - (max_length - 1 if drop_last else 0), max_length):
            chunk = ids[s:s + max_length]
            if len(chunk) == max_length:
                rows.append(np.asarray(chunk, np.int32))
            elif not drop_last and chunk:
                row = np.zeros((max_length,), np.int32)
                row[:len(chunk)] = chunk
                rows.append(row)
    if not rows:
        return np.zeros((0, max_length), np.int32)
    return np.stack(rows)


def chunk_tokens(ids: tp.Sequence[int], max_length: int) -> np.ndarray:
    return tokenize_texts([""], get_tokenizer(), max_length) if not ids else np.stack([
        np.asarray(ids[s:s + max_length], np.int32)
        for s in range(0, len(ids) - max_length + 1, max_length)
    ])


def _synthetic_corpus(n_docs: int = 64, seed: int = 0) -> tp.Iterator[str]:
    rng = np.random.default_rng(seed)
    words = ["photo", "cat", "dog", "bird", "tree", "car", "blue", "red",
             "small", "large", "a", "the", "of", "on", "in"]
    for _ in range(n_docs):
        n = int(rng.integers(20, 200))
        yield " ".join(rng.choice(words, size=n))


def iter_corpus_texts(source_cfg) -> tp.Iterator[str]:
    """Yield documents from the configured source."""
    kind = source_cfg.get("kind", "synthetic")
    if kind == "synthetic":
        yield from _synthetic_corpus(int(source_cfg.get("n_docs", 64)))
    elif kind == "text_files":
        pattern = source_cfg.get("glob", "*.txt")
        root = Path(source_cfg.root)
        for p in sorted(root.glob(pattern)):
            yield p.read_text(errors="replace")
    elif kind == "hf_dataset":
        from datasets import load_dataset, load_from_disk  # optional dependency

        if source_cfg.get("disk_path"):
            ds = load_from_disk(source_cfg.disk_path)
        else:
            ds = load_dataset(source_cfg.name, source_cfg.get("config"),
                              split=source_cfg.get("split", "train"))
        col = source_cfg.get("text_column", "text")
        for ex in ds:
            yield ex[col]
    else:
        raise ValueError(f"Unknown corpus kind: {kind!r}")


@C.main(config_path="../conf", config_name="tokenize_dataset")
def run(cfg) -> None:
    logging.info("Start!")
    tokenizer = get_tokenizer()
    tokens = tokenize_texts(iter_corpus_texts(cfg.source), tokenizer, int(cfg.max_length))
    out = Path(str(cfg.output_path))
    save_array(out, tokens)
    logging.info(f"Saved {tokens.shape[0]} chunks of {cfg.max_length} tokens to {out}")


if __name__ == "__main__":
    run()
