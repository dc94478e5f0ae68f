"""Prompt-learning plumbing: collators, init prompters, text batchers, LM losses.

Counterpart of ``summer_clip_tpu/methods/prompt_learner.py``:

- :class:`LeftPromptCollator` builds ``[SOT] <prompt x P> <class tokens> [EOT]``
  id tables padded to the CLIP context and :func:`splice_prompt_embeds` puts
  the trainable prompt embeddings at positions 1..P of the embedded batch, so
  the gradient flows through the frozen text tower into the prompt. The class
  rows are built once into a fixed (C, T) table; a train step gathers rows;
- init prompters give the initial prompt ids (text, token list, a repeated
  token, random vocabulary ids);
- text batchers choose which class strings feed the LM fluency loss;
- LM losses: full-sequence CE, suffix-only CE (prompt positions excluded),
  and the no-op loss.

Id tables stay numpy on the host (int32, as the JAX package's); the gathers
and losses run on the tensors' device.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

__all__ = [
    "LeftPromptCollator", "splice_prompt_embeds",
    "InitTextPrompter", "InitTokensPrompter", "InitNumTokensPrompter", "InitRandomPrompter",
    "ImageTextBatcher", "OneTextBatcher", "OneStrTextBatcher", "EmptyTextBatcher",
    "FullLMLoss", "SuffixLMLoss", "NoLMLoss",
]


def splice_prompt_embeds(token_embeds: torch.Tensor, prompt_embeds: torch.Tensor) -> torch.Tensor:
    """Replace positions 1..P of (B, T, D) embeddings with the (P, D) prompt
    (out of place, so the prompt's gradient flows)."""
    b, p = token_embeds.shape[0], prompt_embeds.shape[0]
    prompt = prompt_embeds.to(token_embeds.dtype)[None].expand(b, p, prompt_embeds.shape[1])
    return torch.cat([token_embeds[:, :1], prompt, token_embeds[:, 1 + p:]], dim=1)


class LeftPromptCollator:
    """Builds CLIP / GPT input id tables for prompt learning.

    ``tokenizer`` is the CLIP BPE tokenizer (SOT doubles as BOS, EOT as EOS).
    """

    def __init__(self, tokenizer, prompt_len: int, clip_seq_len: int = 77):
        self.tokenizer = tokenizer
        self.prompt_len = prompt_len
        self.clip_seq_len = clip_seq_len
        self.bos_id = tokenizer.sot_token
        self.eos_id = tokenizer.eot_token

    def tokenize_classes(self, classnames: tp.Sequence[str]) -> tp.List[tp.List[int]]:
        return [self.tokenizer.encode(str(c).replace("_", " ")) for c in classnames]

    def build_class_table(self, token_classes: tp.Sequence[tp.Sequence[int]]
                          ) -> tp.Tuple[np.ndarray, np.ndarray]:
        """(C, clip_seq_len) id rows ``[SOT, 0*P, class, EOT, pad...]`` + lens."""
        c = len(token_classes)
        p = self.prompt_len
        ids = np.zeros((c, self.clip_seq_len), np.int32)
        lens = np.zeros((c,), np.int32)
        for row, toks in enumerate(token_classes):
            toks = list(toks)
            total = 1 + p + len(toks) + 1
            if total > self.clip_seq_len:
                toks = toks[: self.clip_seq_len - p - 2]
                total = self.clip_seq_len
            ids[row, 0] = self.bos_id
            ids[row, 1 + p: 1 + p + len(toks)] = toks
            ids[row, 1 + p + len(toks)] = self.eos_id
            lens[row] = total
        return ids, lens

    def get_clip_input(self, class_table: tp.Tuple[np.ndarray, np.ndarray], class_idx
                       ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        ids, lens = class_table
        idx = torch.as_tensor(np.asarray(class_idx), dtype=torch.long)
        return torch.from_numpy(ids)[idx].long(), torch.from_numpy(lens)[idx].long()

    def get_gpt_input(self, class_table: tp.Tuple[np.ndarray, np.ndarray], class_idx,
                      prompt_ids: tp.Optional[torch.Tensor] = None
                      ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(ids (B, T), lens, loss_mask) for the LM pass: no trailing EOT.

        ``prompt_ids`` (P,), when given, fills positions 1..P so FullLMLoss
        sees the discrete prompt; loss positions beyond ``len - 1`` are masked.
        """
        ids, lens = self.get_clip_input(class_table, class_idx)
        pos = torch.arange(ids.shape[1])[None, :]
        ids = torch.where(pos == (lens - 1)[:, None], 0, ids)
        lens = lens - 1
        if prompt_ids is not None:
            ids[:, 1:1 + self.prompt_len] = torch.as_tensor(prompt_ids).to(ids)[None].cpu()
        mask = (pos < lens[:, None]).float()
        return ids, lens, mask


# ---------------------------------------------------------------------------
# Init prompters
# ---------------------------------------------------------------------------

class InitTextPrompter:
    def __init__(self, text: str, assert_length: tp.Optional[int] = None):
        self.text = text
        self.assert_length = assert_length

    def get_ids(self, tokenizer) -> tp.List[int]:
        ids = tokenizer.encode(self.text)
        if self.assert_length is not None:
            assert len(ids) == self.assert_length, "Lens do not match"
        return ids


class InitTokensPrompter:
    def __init__(self, tokens: tp.List[str]):
        self.tokens = tokens

    def get_ids(self, tokenizer) -> tp.List[int]:
        out: tp.List[int] = []
        for tok in self.tokens:
            out.extend(tokenizer.encode(tok))
        return out


class InitNumTokensPrompter:
    def __init__(self, token: str, length: int):
        self.token = token
        self.length = length

    def get_ids(self, tokenizer) -> tp.List[int]:
        # the token's (first) id, ``length`` times
        tok_ids = tokenizer.encode(self.token)
        assert tok_ids, f"token {self.token!r} tokenizes to nothing"
        return [tok_ids[0]] * self.length


class InitRandomPrompter:
    def __init__(self, length: int, seed: tp.Optional[int] = None):
        self.length = length
        self.rng = np.random.default_rng(seed)

    def get_ids(self, tokenizer) -> tp.List[int]:
        special = {tokenizer.sot_token, tokenizer.eot_token, 0}
        vocab = np.setdiff1d(np.arange(tokenizer.vocab_size), np.asarray(sorted(special)))
        return [int(i) for i in self.rng.choice(vocab, size=self.length, replace=True)]


# ---------------------------------------------------------------------------
# Text batchers
# ---------------------------------------------------------------------------

class ImageTextBatcher:
    """LM loss sees each batch image's class string."""

    def __init__(self, num_classes: int, class_ind: tp.Optional[int] = None,
                 text_classes: tp.Optional[tp.Sequence[str]] = None):
        del class_ind, text_classes
        self.num_classes = num_classes

    def get_batch_classes(self, batch_labels: np.ndarray) -> np.ndarray:
        return np.asarray(batch_labels)


class OneTextBatcher:
    """LM loss sees one fixed class per step."""

    def __init__(self, num_classes: int, class_ind: int,
                 text_classes: tp.Optional[tp.Sequence[str]] = None):
        del text_classes
        self.class_ind = class_ind

    def get_batch_classes(self, batch_labels: np.ndarray) -> np.ndarray:
        return np.asarray([self.class_ind])


class OneStrTextBatcher(OneTextBatcher):
    def __init__(self, num_classes: int, class_str: str,
                 text_classes: tp.Sequence[str] = ()):
        super().__init__(num_classes, list(text_classes).index(class_str))


class EmptyTextBatcher:
    """LM loss sees the bare prompt (empty class suffix): the row the class
    table appends after the last class."""

    def __init__(self, num_classes: int, class_ind: tp.Optional[int] = None,
                 text_classes: tp.Optional[tp.Sequence[str]] = None):
        self.empty_index = num_classes

    def get_batch_classes(self, batch_labels: np.ndarray) -> np.ndarray:
        return np.asarray([self.empty_index])


# ---------------------------------------------------------------------------
# LM losses
# ---------------------------------------------------------------------------

def _shifted_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE: logits[:, t] predicts labels[:, t+1]."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = labels[:, 1:].long().to(logp.device)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    m = mask[:, 1:].to(nll)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


class FullLMLoss:
    def transform(self, ids: torch.Tensor, mask: torch.Tensor,
                  logits: torch.Tensor) -> torch.Tensor:
        return _shifted_ce(logits, ids, mask)


class SuffixLMLoss:
    """CE only on the class-suffix tokens (prompt positions excluded)."""

    def __init__(self, prompt_len: int, has_bos: bool = True):
        self.prefix_len = prompt_len + (1 if has_bos else 0)

    def transform(self, ids: torch.Tensor, mask: torch.Tensor,
                  logits: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=mask.device)[None, :]
        return _shifted_ce(logits, ids, mask * (pos >= self.prefix_len))


class NoLMLoss:
    def transform(self, ids, mask, logits) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32)
