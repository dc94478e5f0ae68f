"""Vocabulary filters: restrict the searchable prompt-token space.

Copy of ``summer_clip_tpu/methods/vocab_filters.py`` (no JAX in it).

Rebuild of ``summer_clip/clip_prompt/vocab_filters.py`` over this
framework's CLIP BPE tokenizer. Each filter returns a sorted list of
allowed global token ids (or None = unrestricted).
"""

from __future__ import annotations

import typing as tp

try:
    import regex as re
except ImportError:  # pragma: no cover
    import re  # type: ignore

__all__ = [
    "BaseVocabFilter", "NoFilter", "AllowedTokensFilter", "NotAllowedTokensFilter",
    "FilterNonBasicStrong", "PromptsUnionFilter",
]


class BaseVocabFilter:
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def get_allowed_tokens(self) -> tp.Optional[tp.List[int]]:
        raise NotImplementedError


class NoFilter(BaseVocabFilter):
    def get_allowed_tokens(self) -> None:
        return None


class AllowedTokensFilter(BaseVocabFilter):
    """Keep exactly the listed token strings (tokenized, flattened)."""

    def __init__(self, tokenizer, tokens: tp.Sequence[str]):
        super().__init__(tokenizer)
        self.tokens = tokens

    def get_allowed_tokens(self) -> tp.List[int]:
        ids: tp.Set[int] = set()
        for tok in self.tokens:
            ids.update(self.tokenizer.encode(tok))
        return sorted(ids)


class NotAllowedTokensFilter(BaseVocabFilter):
    """Whole vocab minus the listed token strings."""

    def __init__(self, tokenizer, tokens: tp.Sequence[str]):
        super().__init__(tokenizer)
        self.tokens = tokens

    def get_allowed_tokens(self) -> tp.List[int]:
        banned: tp.Set[int] = set()
        for tok in self.tokens:
            banned.update(self.tokenizer.encode(tok))
        banned.update({self.tokenizer.sot_token, self.tokenizer.eot_token})
        return [i for i in range(self.tokenizer.vocab_size) if i not in banned]


class FilterNonBasicStrong(BaseVocabFilter):
    """Keep tokens made of basic english letters / digits / punctuation
    (reference vocab_filters.py:54-79)."""

    PATTERN = re.compile(r"^[a-z0-9 !\"#$%&'()*+,\-./:;<=>?@\[\]^_`{|}~]+$")

    def get_allowed_tokens(self) -> tp.List[int]:
        allowed = []
        decoder: tp.Dict[int, str] = self.tokenizer.decoder
        specials = {self.tokenizer.sot_token, self.tokenizer.eot_token}
        for tid, tok in decoder.items():
            if tid in specials or tok.startswith("<|"):
                continue
            text = self.tokenizer.decode([tid])
            if text and self.PATTERN.match(text):
                allowed.append(tid)
        return sorted(allowed)


class PromptsUnionFilter(BaseVocabFilter):
    """Union of tokens appearing in given prompt strings and class names."""

    def __init__(self, tokenizer, prompts: tp.Sequence[str] = (),
                 classes: tp.Sequence[str] = ()):
        super().__init__(tokenizer)
        self.texts = list(prompts) + [str(c).replace("_", " ") for c in classes]

    def get_allowed_tokens(self) -> tp.List[int]:
        ids: tp.Set[int] = set()
        for text in self.texts:
            ids.update(self.tokenizer.encode(text))
        return sorted(ids)
