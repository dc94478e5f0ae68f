"""ClipGPT evaluation & generation.

Counterpart of ``summer_clip_tpu/apps/gen_gpt.py``: loads a ClipGPT step
checkpoint, reports perplexity on a validation token matrix, and samples
continuations for a fixed prompt list through the KV cache (temperature,
top-k, nucleus). Results go to ``results.yaml`` and ``records.jsonl``.

Three samplers, as in the JAX package:

- :func:`generate` -- the host loop: reads every token back and stops at eot.
  The parity oracle (``generation.device_loop=false``).
- :func:`generate_device` -- the device loop (default). Where the JAX package
  runs prefill and a ``lax.scan`` as one jitted program, this is a Python loop
  that never reads a tensor back inside it: sampling, the eot freeze and the
  in-place cache update stay on the device and the tokens are fetched once at
  the end. Given the same generator seed it draws what :func:`generate` draws.
- :func:`generate_device_batched` -- all prompts in one loop: left-padded to a
  shared length (bucketed to 16), per-row position offsets, ``key_pad``.

``generation.quant_int8=true`` runs the samplers over an int8 tree consumed as
stored: every decode-shaped product streams through K7
(``ops/gemv.streamed_qmatmul``), the head reads an int8 table built once before
the loop, and ``SUMMER_CLIP_FUSED_MLP=1`` sends each block's MLP pair through
K10. ``torch.multinomial`` cannot reproduce ``jax.random.categorical``: greedy
(``top_k=1``) ids equal the JAX package's, sampled ids do not.

``generation.megakernel`` sends the decode steps of the device loop and of the
batched sampler through K8 (``ops/decode_block``): prefill by the standard wide
forward, the cache converted once into int8 rings, then a token is embed (+
adapters) -> K8 -> ring update -> ``ln_f`` -> hoisted head table -> pick.
``auto`` resolves by the JAX package's rule: an int8 tree, the device loop, at
least 24 blocks and a legal geometry (batched: at most 8 prompts too).
``megakernel=true`` without ``quant_int8`` stores weights and rings in bf16.
``generation.continuous=true`` drains the prompts through the
continuous-batching engine (``engine/serving``), ``generation.speculative=true``
through draft-model speculation (``engine/speculative``; both trees stay in
full precision and ``quant_int8`` is ignored there, as in the JAX app).
``generation.tp > 1`` raises
``NotImplementedError`` (ROADMAP Queue 1 item 11). ``approx_top_k`` is accepted
and runs the exact top-k.

Run: ``python -m summer_clip_torch.apps.gen_gpt model.checkpoint_dir=<dir>
generation.quant_int8=true`` (``meta.device=cpu`` for the CPU).
"""

from __future__ import annotations

import logging
import typing as tp
from pathlib import Path

import numpy as np
import torch
import yaml

from summer_clip_torch.apps.train_gpt import lm_loss_fn
from summer_clip_torch.core import config as C
from summer_clip_torch.engine import checkpoint as ckpt
from summer_clip_torch.engine.quant import quant_head_table, quantize_tree
from summer_clip_torch.engine.trainer import BaseTrainer, resolve_device, run_trainer
from summer_clip_torch.models import gpt2 as gpt2_mod
from summer_clip_torch.models.tokenizer import get_tokenizer
from summer_clip_torch.ops import decode_block as DB
from summer_clip_torch.ops.gemv import is_qleaf, matmul_reference, qdot
from summer_clip_torch.store import load_array

__all__ = ["build_clip_gpt", "save_clip_gpt_checkpoint", "load_pretrained_clip_gpt", "generate",
           "generate_device", "generate_device_batched", "GptGenerator", "run"]


def build_clip_gpt(model_cfg: tp.Mapping[str, tp.Any], vocab_size: int, seed: int,
                   device: tp.Union[None, str, torch.device] = None) -> gpt2_mod.ClipGPT:
    """A ClipGPT of ``model_cfg`` (``gpt_config``, ``clip_emb_dim``,
    ``adapters.{emb_hid_dim, head_hid_dim}``) on ``device`` (the card when
    there is one, unless the caller names another), initialised from ``seed``.
    The numbers are drawn by CPU generators whatever the device, so the same
    seed gives the same weights everywhere, which is how a trainable-only
    checkpoint gets its frozen leaves back."""
    gpt_cfg = gpt2_mod.GPT2_CONFIGS[str(model_cfg.get("gpt_config", "gpt2-large"))]
    adapters = model_cfg.get("adapters") or {}
    model = gpt2_mod.ClipGPT(
        gpt_cfg, clip_vocab_size=vocab_size,
        clip_emb_dim=int(model_cfg.get("clip_emb_dim", 512)),
        emb_hid_dim=int(adapters.get("emb_hid_dim", 1024)),
        head_hid_dim=adapters.get("head_hid_dim", 1024), device=resolve_device(device))
    return model.init_weights(torch.Generator().manual_seed(int(seed)))


def save_clip_gpt_checkpoint(ckpt_dir: tp.Union[str, Path], model: gpt2_mod.ClipGPT,
                             model_cfg: tp.Mapping[str, tp.Any], seed: int,
                             keep=gpt2_mod.clip_gpt_trainable_mask,
                             step: tp.Optional[int] = None) -> Path:
    """A step checkpoint as the trainer writes it: the trainable subset of the
    tree, and in ``meta.yaml`` the model config and the seed that initialised
    the model."""
    meta = {"model_cfg": dict(model_cfg), "init_seed": int(seed)}
    return ckpt.save_checkpoint(ckpt_dir, params=model.tree(), meta=meta, keep=keep, step=step)


def load_pretrained_clip_gpt(checkpoint_dir: tp.Union[str, Path], tokenizer, seed: int = 0,
                             device: tp.Union[None, str, torch.device] = None
                             ) -> gpt2_mod.ClipGPT:
    """Rebuild a ClipGPT from a step checkpoint's ``model_cfg`` and parameters,
    on ``device`` (the card when there is one, unless the caller names
    another).

    Checkpoints hold only the trainable subset; the frozen leaves (the
    embedding table, and the whole core for adapters-only runs) are
    initialised again from the seed that the checkpoint's meta records, so
    they come out as they were, whatever this run's seed or device. ``seed``
    serves only a checkpoint without that record."""
    device = resolve_device(device)
    loaded = ckpt.load_checkpoint(checkpoint_dir)
    meta = loaded.get("meta") or {}
    model = build_clip_gpt(meta.get("model_cfg") or {}, tokenizer.vocab_size,
                           meta.get("init_seed", seed), device)
    if "params" in loaded:
        model.load_tree(loaded["params"], device=device)
    return model.eval()


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def _filter_logits(scaled: torch.Tensor, top_k: int, top_p: float
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Top-k cut, then nucleus cut; dropped entries become -inf in ``vals``.

    Returns ``(vals, idx)`` sorted by descending logit; the surviving token
    set is what HF's TopKLogitsWarper -> TopPLogitsWarper chain keeps: softmax
    over the surviving logits, then a token stays iff the cumulative
    probability of strictly better tokens is still < ``top_p`` (the best token
    always stays). ``top_k=0``: the nucleus runs over the whole sorted vocab."""
    k = int(top_k) if top_k else scaled.shape[-1]
    vals, idx = torch.topk(scaled, k, dim=-1)
    if top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        vals = torch.where(cum - probs < top_p, vals, float("-inf"))
    return vals, idx


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[..., 0]


def _sample_next(scaled: torch.Tensor, generator: torch.Generator, top_k: int,
                 top_p: float = 1.0) -> torch.Tensor:
    """One sampling pick over (..., V) logits, shared by the three samplers."""
    if not top_k and top_p >= 1.0:
        return _categorical(scaled, generator)
    vals, idx = _filter_logits(scaled, top_k, top_p)
    pick = _categorical(vals, generator)
    return idx.gather(-1, pick[..., None])[..., 0]


def _generator_for(generator: tp.Optional[torch.Generator], device: torch.device
                   ) -> torch.Generator:
    """``torch.multinomial`` needs a generator on the logits' device."""
    if generator is None:
        return torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"the sampler needs a generator on {device}, got one on {generator.device}")
    return generator


def _head(model, quant_int8: bool) -> tp.Callable[[torch.Tensor], torch.Tensor]:
    """Logits of the last hidden row off a head table built once before the
    loop: the int8 table through K7 on an int8 tree, else the f32 table. Inside
    the model the 49k-row head adapter would run again every token."""
    if quant_int8:
        table = quant_head_table(model)
        return lambda h: qdot(h, table, torch.float32)
    if isinstance(model, gpt2_mod.ClipGPT):
        table = model.lm_head_table()
        return lambda h: gpt2_mod.logits_f32(h, table)
    return model.head_logits


def _mega_state(model, what: str):
    """What the megakernel loops build once before the loop: the packed block
    parameters (int8 as stored on an int8 tree, else bf16), the final
    LayerNorm as a function of K8's output, and the head: the int8 table
    through K7, else a bf16 table (bf16 operands, f32 sums)."""
    cfg = model.config
    if not DB.mega_legal(cfg.n_embd, 4 * cfg.n_embd, cfg.n_head):
        raise ValueError(f"the megakernel does not support {cfg.name} geometry ({what})")
    tree = model.tree()
    store = "int8" if is_qleaf(tree["core"]["h_0"]["attn"]["c_attn"]["kernel"]) else "bf16"
    packed = DB.pack_core_params(tree["core"], cfg.n_layer, store=store)
    lnf = model.core.ln_f
    if store == "int8":
        table = quant_head_table(model)
        head = lambda h: qdot(h, table, torch.float32)   # noqa: E731
    else:
        wide = (model.lm_head_table() if isinstance(model, gpt2_mod.ClipGPT)
                else model.wte.embedding).t().contiguous()
        head = lambda h: matmul_reference(h, wide)       # noqa: E731
    return packed, (lambda y: head(DB._ln_rows(y, lnf.scale[None], lnf.bias[None])))


def _device_of(model) -> torch.device:
    return model.core.ln_f.scale.device


def _trim(prompt_ids: tp.Sequence[int], toks: tp.Iterable[int], eot_id: tp.Optional[int]
          ) -> tp.List[int]:
    out_ids = [int(i) for i in prompt_ids]
    for t in toks:
        out_ids.append(int(t))
        if eot_id is not None and int(t) == eot_id:
            break
    return out_ids


@torch.inference_mode()
def generate(model, prompt_ids: tp.Sequence[int], *, max_new_tokens: int = 20,
             temperature: float = 1.0, top_k: int = 50,
             generator: tp.Optional[torch.Generator] = None, eot_id: tp.Optional[int] = None,
             top_p: float = 1.0) -> tp.List[int]:
    """Incremental sampling through the KV cache, one read-back per token."""
    device = _device_of(model)
    generator = _generator_for(generator, device)
    cache = model.init_cache(1, len(prompt_ids) + max_new_tokens)
    ids = torch.tensor([list(prompt_ids)], dtype=torch.long, device=device)
    out = model(ids, position_offset=0, cache=cache)
    logits, cache = out["logits"][:, -1, :], out["cache"]
    out_ids = [int(i) for i in prompt_ids]
    offset = len(prompt_ids)
    for _ in range(max_new_tokens):
        scaled = logits[0] / max(temperature, 1e-6)
        nxt = int(_sample_next(scaled, generator, int(top_k), float(top_p)))
        out_ids.append(nxt)
        if eot_id is not None and nxt == eot_id:
            break
        out = model(torch.tensor([[nxt]], dtype=torch.long, device=device),
                    position_offset=offset, cache=cache)
        logits, cache = out["logits"][:, -1, :], out["cache"]
        offset += 1
    return out_ids


@torch.inference_mode()
def generate_device(model, prompt_ids: tp.Sequence[int], *, max_new_tokens: int = 20,
                    temperature: float = 1.0, top_k: int = 50,
                    generator: tp.Optional[torch.Generator] = None,
                    eot_id: tp.Optional[int] = None, approx_top_k: bool = False,
                    quant_int8: bool = False, top_p: float = 1.0,
                    megakernel: bool = False) -> tp.List[int]:
    """Whole-sequence sampling without a read-back inside the loop.

    The host loop pays a device synchronisation per token for its fetched
    pick. Here the KV cache, the generator and the last logits stay on the
    device and the tokens are fetched once at the end. The draws are those of
    :func:`generate`, so the same generator seed gives the same ids. After an
    ``eot_id`` the row freezes (emits eot), which matches the host loop's
    early break once the result is cut at the first eot. ``quant_int8``:
    ``model`` holds an int8 tree (``engine.quant.quantize_tree``).

    ``megakernel``: after the wide prefill the cache becomes K8's rings (int8
    with ``quant_int8``, else bf16) and every decode step runs the whole block
    stack in one launch; the position is a device tensor, so nothing is read
    back here either."""
    del approx_top_k   # the exact top-k runs
    device = _device_of(model)
    generator = _generator_for(generator, device)
    n_prompt = len(prompt_ids)
    if n_prompt + max_new_tokens > model.config.n_positions:
        raise ValueError(f"prompt {n_prompt} + max_new_tokens {max_new_tokens} exceeds the "
                         f"model's {model.config.n_positions} positions")
    temp = max(float(temperature), 1e-6)
    eot = -1 if eot_id is None else int(eot_id)
    cache = model.init_cache(1, n_prompt + max_new_tokens)
    ids = torch.tensor([list(prompt_ids)], dtype=torch.long, device=device)
    out = model(ids, position_offset=0, cache=cache)
    last, cache = out["logits"][:, -1, :], out["cache"]
    if megakernel:
        packed, mega_head = _mega_state(model, "generate_device")
        kv = DB.cache_to_mega(cache, n_prompt + max_new_tokens,
                              torch.int8 if quant_int8 else torch.bfloat16)
        offset = torch.full((1,), n_prompt, dtype=torch.long, device=device)
    else:
        head = _head(model, quant_int8)
    done = torch.zeros((), dtype=torch.bool, device=device)
    toks = []
    for step in range(max_new_tokens):
        nxt = _sample_next(last[0] / temp, generator, int(top_k), float(top_p))
        nxt = torch.where(done, eot, nxt)
        done = done | (nxt == eot)
        toks.append(nxt)
        if step + 1 == max_new_tokens:
            break   # the logits after the last token would be dropped
        if megakernel:
            x = gpt2_mod.decode_inputs(model, nxt[None], offset)
            y, *fresh = DB.decode_block(x, packed, kv, offset, nh=model.config.n_head)
            DB.mega_update_kv(kv, *fresh, offset)
            last, offset = mega_head(y), offset + 1
            continue
        out = model(nxt[None, None], position_offset=n_prompt + step, cache=cache,
                    compute_logits=False)
        last, cache = head(out["hidden"][:, -1, :]), out["cache"]
    return _trim(prompt_ids, torch.stack(toks).cpu().tolist(), eot_id)


@torch.inference_mode()
def generate_device_batched(model, prompts: tp.Sequence[tp.Sequence[int]], *,
                            max_new_tokens: int = 20, temperature: float = 1.0, top_k: int = 50,
                            generator: tp.Optional[torch.Generator] = None,
                            eot_id: tp.Optional[int] = None, approx_top_k: bool = False,
                            quant_int8: bool = False, top_p: float = 1.0,
                            megakernel: bool = False) -> tp.List[tp.List[int]]:
    """Batched serving path: sample B variable-length prompts in one loop.

    Prompts are left-padded to a shared length so that every row appends at
    the same cache slot; per-row position offsets (``position_offset`` as a
    (B, 1) tensor) put position 0 at each row's first real token, and
    ``key_pad`` masks the pad slots out of attention for good. Rows freeze
    independently on ``eot_id``. One generator drives the whole batch.

    ``megakernel`` (at most 8 prompts): the decode steps run the whole block
    stack for the batch in one launch of K8 each, so the weight read of a token
    is shared by the rows; the prefill goes into a short cache that becomes the
    rings, and the left pads ride K8's ``pad`` mask."""
    del approx_top_k
    device = _device_of(model)
    generator = _generator_for(generator, device)
    lens = [len(p) for p in prompts]
    if min(lens) <= 0:
        raise ValueError("empty prompt")
    if max(lens) + max_new_tokens > model.config.n_positions:
        raise ValueError(f"longest prompt {max(lens)} + max_new_tokens {max_new_tokens} exceeds "
                         f"the model's {model.config.n_positions} positions")
    # the padded length is bucketed to a multiple of 16, as in the JAX package
    # (there it bounds the number of compiled programs); the extra pad columns
    # are masked by key_pad like any other pad
    l_max = min(-(-max(lens) // 16) * 16, model.config.n_positions - max_new_tokens)
    ids = np.zeros((len(prompts), l_max), np.int64)
    for r, p in enumerate(prompts):
        ids[r, l_max - len(p):] = p
    pad = torch.tensor([l_max - n for n in lens], dtype=torch.long, device=device)
    temp = max(float(temperature), 1e-6)
    eot = -1 if eot_id is None else int(eot_id)
    if megakernel and len(prompts) > DB.MAX_STREAMS:
        raise ValueError(f"the megakernel carries at most {DB.MAX_STREAMS} streams, got "
                         f"{len(prompts)} prompts")
    # the megakernel's prefill needs the prompt window only: the rings own the rest
    cache = model.init_cache(len(prompts), l_max if megakernel else l_max + max_new_tokens)
    out = model(torch.from_numpy(ids).to(device), position_offset=(-pad)[:, None], cache=cache,
                key_pad=pad)
    last, cache = out["logits"][:, -1, :], out["cache"]
    if megakernel:
        packed, mega_head = _mega_state(model, "generate_device_batched")
        kv = DB.cache_to_mega(cache, l_max + max_new_tokens,
                              torch.int8 if quant_int8 else torch.bfloat16, batched=True)
        slot = torch.full((len(prompts),), l_max, dtype=torch.long, device=device)
    else:
        head = _head(model, quant_int8)
    done = torch.zeros(len(prompts), dtype=torch.bool, device=device)
    toks = []
    for step in range(max_new_tokens):
        nxt = _sample_next(last / temp, generator, int(top_k), float(top_p))
        nxt = torch.where(done, eot, nxt)
        done = done | (nxt == eot)
        toks.append(nxt)
        if step + 1 == max_new_tokens:
            break
        if megakernel:
            x = gpt2_mod.decode_inputs(model, nxt, slot - pad)
            y, *fresh = DB.decode_block(x, packed, kv, slot, nh=model.config.n_head, pad=pad)
            DB.mega_update_kv(kv, *fresh, slot)
            last, slot = mega_head(y), slot + 1
            continue
        out = model(nxt[:, None], position_offset=(l_max + step - pad)[:, None], cache=cache,
                    key_pad=pad, compute_logits=False)
        last, cache = head(out["hidden"][:, -1, :]), out["cache"]
    toks_host = torch.stack(toks).cpu().numpy()   # (max_new, B)
    return [_trim(p, toks_host[:, r], eot_id) for r, p in enumerate(prompts)]


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------
class GptGenerator(BaseTrainer):
    def setup_dataset(self):
        self.tokenizer = get_tokenizer()
        vcfg = self.cfg.get("val")
        self.val_tokens = (np.array(load_array(vcfg.tokens_path), np.int64)   # a writable copy
                           if vcfg and vcfg.get("tokens_path") else None)

    def setup_model(self):
        seed = int(self.cfg.get("meta", {}).get("random_state", 42))
        self.model = load_pretrained_clip_gpt(self.cfg.model.checkpoint_dir, self.tokenizer,
                                              seed=seed, device=self.device)

    @torch.inference_mode()
    def perplexity(self) -> tp.Optional[float]:
        if self.val_tokens is None:
            return None
        bs = int(self.cfg.get("batch_size", 8))
        losses = []
        for s in range(0, max(len(self.val_tokens) - bs + 1, 1), bs):
            ids = torch.from_numpy(self.val_tokens[s:s + bs]).to(self.device)
            losses.append(lm_loss_fn(self.model(ids)["logits"], ids))
        return float(np.exp(np.mean([float(x) for x in losses]))) if losses else None

    def _prompt_generator(self) -> torch.Generator:
        """A generator on the model's device for one sampler call, seeded from
        the run's generator (the counterpart of a ``jax.random.split``)."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self.generator))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _check_ported(self, gcfg) -> None:
        if int(gcfg.get("tp", 1)) > 1:
            raise NotImplementedError("generation.tp > 1 needs the tensor-parallel decode "
                                      "(parallel/tp), which is not ported yet: ROADMAP Queue 1 "
                                      "item 11")

    def _megakernel(self, gcfg, quant: bool, fits: bool) -> bool:
        """``generation.megakernel``: true, false, or ``auto``, which rides the
        int8 tree only (the megakernel stores bf16 otherwise, which would
        demote an f32 run's numerics; an explicit true opts into that), a
        stack of at least 24 blocks and a legal geometry; ``fits``: what the
        caller adds (the device loop; at most 8 rows)."""
        mk = gcfg.get("megakernel", "auto")
        if mk != "auto":
            return bool(mk)
        cfg = self.model.config
        return (quant and fits and cfg.n_layer >= 24
                and DB.mega_legal(cfg.n_embd, 4 * cfg.n_embd, cfg.n_head))

    def _serve_continuous(self, gcfg, ids_all, quant: bool) -> tp.List[tp.List[int]]:
        """The continuous-batching engine: here it drains the prompt list, but
        the same engine serves a live request stream."""
        from summer_clip_torch.engine.serving import ContinuousBatcher

        max_new = int(gcfg.max_new_tokens)
        slots = int(gcfg.get("batch_slots", 8))
        mk = self._megakernel(gcfg, quant, slots <= DB.MAX_STREAMS)
        l_top = max(len(i) for i in ids_all)
        if mk:   # the megakernel admits through the bucketed prefill: capacity
            l_top = -(-l_top // ContinuousBatcher.PREFILL_BUCKET) * ContinuousBatcher.PREFILL_BUCKET
        eng = ContinuousBatcher(
            self.model, batch_slots=slots,
            max_len=min(self.model.config.n_positions, l_top + max_new),
            temperature=float(gcfg.temperature), top_k=int(gcfg.top_k),
            top_p=float(gcfg.get("top_p", 1.0)), burst=int(gcfg.get("burst", 16)),
            pipeline=int(gcfg.get("pipeline", 4)), wave=bool(gcfg.get("wave", True)),
            quant_int8=quant, megakernel=mk, eot_id=self.tokenizer.eot_token,
            generator=self._prompt_generator())
        reqs = [eng.submit(ids, max_new_tokens=max_new) for ids in ids_all]
        eng.run()
        return [ids + r.out_ids for ids, r in zip(ids_all, reqs)]

    def _serve_speculative(self, gcfg, ids_all, quant: bool, n_ret: int) -> tp.List[tp.List[int]]:
        """Greedy speculative decoding: a smaller ClipGPT over the same CLIP
        vocabulary drafts k tokens per verify forward of the target. Both
        models decode their full-precision trees, as in the JAX app:
        ``generation.quant_int8`` is ignored on this arm (int8 speculation is
        ``engine.speculative.generate_device_speculative(quant_int8=True)``)."""
        from summer_clip_torch.engine.speculative import generate_device_speculative

        draft_dir = gcfg.get("draft_checkpoint_dir")
        if not draft_dir:
            raise ValueError("generation.speculative needs generation.draft_checkpoint_dir")
        seed = int(self.cfg.get("meta", {}).get("random_state", 42))
        draft = load_pretrained_clip_gpt(draft_dir, self.tokenizer, seed=seed, device=self.device)
        if int(gcfg.top_k) != 1 or float(gcfg.get("top_p", 1.0)) < 1.0:
            self.logger.log_info("speculative decoding is greedy: top_k, top_p and temperature "
                                 "are ignored")
        if n_ret > 1:
            self.logger.log_info("speculative decoding is deterministic: "
                                 f"num_return_sequences={n_ret} repeats identical samples")
        if quant:
            self.logger.log_info("speculative decoding runs the full-precision trees: "
                                 "generation.quant_int8 is ignored")
        outs, stats = [], []
        for ids in ids_all:
            out, st = generate_device_speculative(
                self.model, draft, ids, max_new_tokens=int(gcfg.max_new_tokens),
                k=int(gcfg.get("speculative_k", 4)), eot_id=self.tokenizer.eot_token,
                return_stats=True)
            outs.append(out), stats.append(st)
        self.logger.log_info({"type": "speculative", "verify_iters": [s["verify_iters"] for s in stats],
                              "emitted": [s["emitted"] for s in stats]})
        return outs

    def train_loop(self):
        results: dict = {"generations": []}
        ppl = self.perplexity()
        if ppl is not None:
            results["perplexity"] = ppl
            self.logger.log_info({"type": "gpt_perplexity", "perplexity": ppl})

        gcfg = self.cfg.generation
        self._check_ported(gcfg)
        base_prompts = [str(p) for p in (self.cfg.prompts or [])]
        # each of num_return_sequences repeats goes through the samplers as a
        # row or a generator of its own, so samples stay independent
        n_ret = max(int(gcfg.get("num_return_sequences", 1)), 1)
        prompts = [p for p in base_prompts for _ in range(n_ret)]
        common = dict(max_new_tokens=int(gcfg.max_new_tokens),
                      temperature=float(gcfg.temperature), top_k=int(gcfg.top_k),
                      eot_id=self.tokenizer.eot_token, top_p=float(gcfg.get("top_p", 1.0)))
        quant = bool(gcfg.get("quant_int8", False))
        ids_all = [[self.tokenizer.sot_token] + self.tokenizer.encode(p) for p in prompts]
        outs: tp.List[tp.List[int]] = []
        model = self.model
        engine = bool(gcfg.get("continuous", False)) or bool(gcfg.get("speculative", False))
        if prompts and quant and not engine:   # the stored-int8 tree through the kernels
            model = model.with_tree(quantize_tree(model.tree())).eval()
        if prompts and bool(gcfg.get("continuous", False)):
            outs = self._serve_continuous(gcfg, ids_all, quant)
        elif prompts and bool(gcfg.get("speculative", False)):
            outs = self._serve_speculative(gcfg, ids_all, quant, n_ret)
        elif prompts and bool(gcfg.get("batched", False)):
            outs = generate_device_batched(
                model, ids_all, generator=self._prompt_generator(), quant_int8=quant,
                megakernel=self._megakernel(gcfg, quant, len(ids_all) <= DB.MAX_STREAMS),
                approx_top_k=bool(gcfg.get("approx_top_k", False)), **common)
        else:
            device_loop = bool(gcfg.get("device_loop", True))
            mk = self._megakernel(gcfg, quant, device_loop) if device_loop else False
            for ids in ids_all:
                if device_loop:
                    outs.append(generate_device(
                        model, ids, generator=self._prompt_generator(), quant_int8=quant,
                        megakernel=mk,
                        approx_top_k=bool(gcfg.get("approx_top_k", False)), **common))
                else:
                    outs.append(generate(model, ids, generator=self._prompt_generator(),
                                         **common))
        for i, (prompt, out_ids) in enumerate(zip(prompts, outs)):
            text = self.tokenizer.decode(out_ids)
            results["generations"].append({"prompt": prompt, "sample": i % n_ret,
                                           "ids": out_ids, "text": text})
            self.logger.log_info({"type": "generation", "prompt": prompt,
                                  "sample": i % n_ret, "text": text})

        Path("results.yaml").write_text(yaml.safe_dump(results, allow_unicode=True))
        logging.info("Saved results.yaml")


@C.main(config_path="../conf", config_name="gen_gpt")
def run(cfg) -> None:
    run_trainer(GptGenerator, cfg)


if __name__ == "__main__":
    run()
