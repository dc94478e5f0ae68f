"""CLIP's tokenizer contract for plain ASCII prompts, written from OpenAI's
``clip/simple_tokenizer.py`` and ``clip.tokenize``.

The vocabulary is OpenAI's: the 256 byte symbols of ``bytes_to_unicode``, the
same with ``</w>`` (a word's last symbol), the merges, then
``<|startoftext|>`` and ``<|endoftext|>`` as the last two of 49,408 ids. This
repository ships no merge table, so the program tokenizes with none; the
benchmark does the same: a word is its bytes, its last one marked ``</w>``,
and the ids between the byte symbols and the two special tokens are unused.
A row is ``<sot> ids <eot>`` padded with zeros to 77.
"""

from __future__ import annotations

import re
import typing as tp

import numpy as np

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
SOT, EOT = VOCAB_SIZE - 2, VOCAB_SIZE - 1
_WORDS = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+")


def bytes_to_unicode() -> tp.Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _byte_ids() -> tp.Dict[int, int]:
    """byte -> its symbol's id (the order of ``bytes_to_unicode``)."""
    return {b: i for i, b in enumerate(bytes_to_unicode())}


def tokenize(texts: tp.Sequence[str]) -> np.ndarray:
    ids_of = _byte_ids()
    out = np.zeros((len(texts), CONTEXT_LENGTH), np.int64)
    for row, text in enumerate(texts):
        text = " ".join(text.split()).lower()
        if not text.isascii():
            raise ValueError(f"the reference tokenizes ASCII prompts only: {text!r}")
        ids = [SOT]
        for word in _WORDS.findall(text):
            raw = word.encode("utf-8")
            ids.extend(ids_of[b] for b in raw[:-1])
            ids.append(256 + ids_of[raw[-1]])
        ids.append(EOT)
        if len(ids) > CONTEXT_LENGTH:
            ids = ids[:CONTEXT_LENGTH - 1] + [EOT]
        out[row, :len(ids)] = ids
    return out
