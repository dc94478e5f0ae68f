"""CLIP byte-level BPE tokenizer (pure Python, dependency-light).

Replaces the reference's use of ``clip.tokenize`` / HF ``CLIPTokenizer``
(e.g. ``summer_clip/clip_model/eval_clip.py:24``, ``clip_prompt/train_coop.py``).
Implements the standard CLIP text tokenizer:

- byte-to-unicode encoding (GPT-2 style reversible byte mapping),
- BPE merges over a ranked merge table with ``</w>`` word-end markers,
- CLIP's token regex and text normalization (ftfy is optional),
- fixed 49,408-token vocabulary with ``<|startoftext|>`` / ``<|endoftext|>``.

The merge table is loaded from the standard ``bpe_simple_vocab_16e6.txt.gz``
file when available (pass ``bpe_path`` or set ``$CLIP_BPE_PATH``). In
fully-offline environments without the asset, the tokenizer degrades to a
**byte-level vocabulary with zero merges** — same API, same special tokens,
same vocab size, deterministic ids — which is sufficient for every
framework-internal use (prompt learning operates on id tensors, not on a
specific segmentation). Real-checkpoint parity requires the merge file.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import typing as tp
from pathlib import Path

import numpy as np

try:
    import regex as re
except ImportError:  # pragma: no cover
    import re  # type: ignore

__all__ = ["SimpleTokenizer", "get_tokenizer", "tokenize", "VOCAB_SIZE", "SOT_TOKEN", "EOT_TOKEN"]

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77


@functools.lru_cache()
def bytes_to_unicode() -> tp.Dict[int, str]:
    """Reversible mapping of bytes to printable unicode chars (GPT-2 scheme)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tp.Tuple[str, ...]) -> tp.Set[tp.Tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def basic_clean(text: str) -> str:
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _default_bpe_path() -> tp.Optional[Path]:
    env = os.environ.get("CLIP_BPE_PATH")
    if env and Path(env).exists():
        return Path(env)
    assets = Path(__file__).parent / "assets"
    for cand in ("bpe_simple_vocab_16e6.txt.gz", "merges.txt", "tokenizer.json"):
        if (assets / cand).exists():
            return assets / cand
    return None


def _load_merges(bpe_path: Path) -> tp.List[tp.Tuple[str, str]]:
    """Merge table from any of the three public formats:

    - openai ``bpe_simple_vocab_16e6.txt.gz`` (header line + merges),
    - HF ``merges.txt`` (``#version`` header + merges),
    - HF tokenizers ``tokenizer.json`` (``model.merges`` list).
    """
    if bpe_path.name.endswith(".json"):
        import json

        blob = json.loads(bpe_path.read_text(encoding="utf-8"))
        raw = blob["model"]["merges"]
        out: tp.List[tp.Tuple[str, str]] = []
        for m in raw:  # either "a b" strings or ["a", "b"] pairs
            a, b = m.split(" ") if isinstance(m, str) else m
            out.append((a, b))
        return out
    is_gz = str(bpe_path).endswith(".gz")
    opener = gzip.open if is_gz else open
    with opener(bpe_path, "rt", encoding="utf-8") as f:  # type: ignore[arg-type]
        lines = f.read().split("\n")
    # the openai .gz asset always carries a header line (its loader drops
    # line 0 unconditionally); HF merges.txt marks it with ``#version``
    if lines and (is_gz or lines[0].startswith("#version") or " " not in lines[0]):
        lines = lines[1:]
    lines = lines[: 49152 - 256 - 2]
    return [tuple(line.split()) for line in lines if line]  # type: ignore[misc]


class SimpleTokenizer:
    def __init__(self, bpe_path: tp.Optional[tp.Union[str, Path]] = None):
        bpe_path = Path(bpe_path) if bpe_path else _default_bpe_path()
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        merges: tp.List[tp.Tuple[str, str]] = []
        if bpe_path is not None and Path(bpe_path).exists():
            merges = _load_merges(Path(bpe_path))
        self.has_merges = bool(merges)

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        if not self.has_merges:
            # pad to the canonical vocab size so model embedding tables and
            # special-token ids keep the production layout
            pad = VOCAB_SIZE - len(vocab)
            vocab = vocab[:-2] + [f"<|unused{i}|>" for i in range(pad)] + vocab[-2:]

        self.encoder: tp.Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: tp.Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
            if hasattr(re, "UNICODE") and re.__name__ == "regex"
            else r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|\w+|\d|\S+",
            re.IGNORECASE,
        )

    # -- vocabulary info ------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

    # -- BPE ------------------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs or not self.bpe_ranks:
            out = " ".join(word)
            self.cache[token] = out
            return out

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: tp.List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    # -- encode / decode -------------------------------------------------------
    def encode(self, text: str) -> tp.List[int]:
        bpe_tokens: tp.List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            if token in ("<|startoftext|>", "<|endoftext|>"):
                bpe_tokens.append(self.encoder[token])
                continue
            token_bytes = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token_bytes).split(" "))
        return bpe_tokens

    def decode(self, tokens: tp.Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(t), "") for t in tokens)
        text = text.replace("<|startoftext|>", "").replace("<|endoftext|>", "")
        out_bytes = bytearray()
        for i, chunk in enumerate(chunks := text.split("</w>")):
            out_bytes.extend(self.byte_decoder[c] for c in chunk if c in self.byte_decoder)
            if i != len(chunks) - 1:
                out_bytes.extend(b" ")
        return out_bytes.decode("utf-8", errors="replace").strip()


SOT_TOKEN = VOCAB_SIZE - 2
EOT_TOKEN = VOCAB_SIZE - 1


@functools.lru_cache()
def get_tokenizer(bpe_path: tp.Optional[str] = None) -> SimpleTokenizer:
    return SimpleTokenizer(bpe_path)


def tokenize(texts: tp.Union[str, tp.Sequence[str]],
             context_length: int = CONTEXT_LENGTH,
             truncate: bool = True,
             tokenizer: tp.Optional[SimpleTokenizer] = None) -> np.ndarray:
    """Tokenize to a fixed-shape (N, context_length) int32 array.

    Matches the ``clip.tokenize`` contract: ``<sot> tokens <eot>`` padded
    with zeros; over-long sequences truncate keeping the final <eot>.
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer or get_tokenizer()
    sot, eot = tok.sot_token, tok.eot_token
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        ids = [sot] + tok.encode(text) + [eot]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"Input too long for context {context_length}: {text!r}")
            ids = ids[:context_length]
            ids[-1] = eot
        out[i, :len(ids)] = ids
    return out
