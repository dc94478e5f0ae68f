"""Why the kernel route's CoOp prompt gradient sits ~1e-2 from the route that
launches no kernel (``chip_smoke.py``'s gradient gate).

Runs on a CUDA card: ``python tools/torch_coop_grad_routes.py [--out FILE]``
(about a minute on an H100). It builds CLIP ViT-L/14 from seed 0 in bf16, as
the CoOp path of ``chip_smoke.py`` holds it, and a CoOp batch at its shape:
1000 class prompts of 77 tokens (``"X X ... X class <i>."``, the 16 prompt
tokens a learnable (16, 768) embedding drawn with std 0.02, as CoOp's init),
32 random unit image features with random labels, the loss CE over
``100 * img @ normalize(text)^T``. Four routes of the text tower:

``kernels``  ``FUSED_BLOCK_MODE="block"``: K5 and K6 forwards, the plain
             version recomputed for each block's backward (``ops/autograd``);
``plain``    ``FUSED_BLOCK_MODE="xla"``, ``SHORT_FUSED_ENABLED=False``: the same
             functions in plain PyTorch, bf16, autograd through them;
``f32``      the plain route on an f32 copy of the tower;
``f64``      the plain route on an f64 copy (LayerNorm still computes in f32):
             the function itself, free of bf16 roundings.

It reads:

``blocks``
    Each of the 12 blocks on equal inputs (the plain route's chain): max |d|
    of the kernel block's output against the plain block's, and of each
    against the f64 block, over max |y|; and the same four outputs when each
    route runs the whole chain on its own outputs (free running). A kernel
    whose rounding points are the module's stays as far from f64 as the plain
    block does.
``vjp``
    Each block's input gradient on equal inputs and an equal upstream gradient,
    kernel route against plain route: the ``_ad`` backward recomputes the
    plain version (``ln_attn_reference``, ``ln_mlp_reference``), the plain
    route differentiates the module's own ops: the same functions with the
    same rounding points (bit for bit on the CPU), f32 sums in whatever order
    the card's libraries take for each.
``grad``
    The prompt gradient of the loss on each route, relative L2 distances and
    cosines between the routes, with the loss of each.

With ``--device cpu --classes 8 --layers 2`` it is a dry run of the script at
a toy size (the kernel route is then the plain version too).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from summer_clip_torch.models.clip import build_clip, modeling  # noqa: E402
from summer_clip_torch.models.tokenizer import get_tokenizer, tokenize  # noqa: E402
from summer_clip_torch.ops import attention as at  # noqa: E402

N_PROMPT = 16
BATCH = 32


def set_route(name: str) -> None:
    """The kernel route ("kernels") or the route that launches no kernel."""
    kernels = name == "kernels"
    modeling.FUSED_BLOCK_MODE = "block" if kernels else "xla"
    at.SHORT_FUSED_ENABLED = kernels


def coop_inputs(model, classes: int, device, seed: int = 0) -> dict:
    """Token embeddings of ``"X X ... X class <i>."`` with the 16 X's cut out,
    the lengths (EOT position + 1), a learnable prompt, image features and
    labels, all from ``seed``."""
    tok = get_tokenizer()
    prompts = [" ".join(["X"] * N_PROMPT) + f" class {i}." for i in range(classes)]
    ids = torch.from_numpy(tokenize(prompts, context_length=77)).to(device)
    lens = ids.argmax(-1) + 1
    with torch.no_grad():
        embeds = model.token_embedding(ids).float()
    gen = torch.Generator().manual_seed(seed)
    prompt = (0.02 * torch.randn(N_PROMPT, embeds.shape[-1], generator=gen)).to(device)
    d_out = model.text_projection.shape[1]
    img = torch.nn.functional.normalize(torch.randn(BATCH, d_out, generator=gen), dim=-1)
    labels = torch.randint(0, classes, (BATCH,), generator=gen)
    assert tok.sot_token == int(ids[0, 0])
    return {"embeds": embeds, "lens": lens, "prompt": prompt, "img": img.to(device),
            "labels": labels.to(device)}


def spliced(inputs: dict, prompt: torch.Tensor) -> torch.Tensor:
    x = inputs["embeds"].clone().to(prompt.dtype)
    x[:, 1:1 + N_PROMPT] = prompt[None]
    return x


def loss_and_grad(model, inputs: dict, dtype: torch.dtype, remat: bool) -> tuple:
    """The CoOp loss and its prompt gradient (f64 copy of the prompt's gradient)."""
    prompt = inputs["prompt"].to(dtype).clone().requires_grad_(True)
    model.transformer.remat = remat
    try:
        txt = model.from_embeds(spliced(inputs, prompt), inputs["lens"]).double()
        txt = txt / txt.norm(dim=-1, keepdim=True)
        logits = 100.0 * inputs["img"].double() @ txt.t()
        loss = torch.nn.functional.cross_entropy(logits, inputs["labels"])
        loss.backward()
    finally:
        model.transformer.remat = False
    return float(loss.detach()), prompt.grad.double()


def block_readings(models: dict, inputs: dict) -> list:
    """Per block: equal-input and free-running distances (see the module doc)."""
    bf16 = models["bf16"]
    x0 = spliced(inputs, inputs["prompt"]).to(torch.bfloat16)
    x0 = x0 + bf16.positional_embedding[:x0.shape[1]].to(x0.dtype)
    own = {"kernels": x0, "plain": x0, "f64": x0.double()}
    chain = x0
    rows = []
    with torch.no_grad():
        for i, block in enumerate(bf16.transformer.resblocks):
            b64 = models["f64"].transformer.resblocks[i]
            set_route("plain")
            y_plain = block(chain, True)
            y64 = b64(chain.double(), True)
            set_route("kernels")
            y_kern = block(chain, True)
            scale = float(y64.abs().max())
            row = {"block": i,
                   "equal_inputs": {
                       "kernels_vs_plain": float((y_kern.double() - y_plain.double()).abs().max())
                       / scale,
                       "kernels_vs_f64": float((y_kern.double() - y64).abs().max()) / scale,
                       "plain_vs_f64": float((y_plain.double() - y64).abs().max()) / scale}}
            own["kernels"] = block(own["kernels"], True)
            set_route("plain")
            own["plain"] = block(own["plain"], True)
            own["f64"] = b64(own["f64"], True)
            scale_free = float(own["f64"].abs().max())
            row["free_running"] = {
                "kernels_vs_plain": float((own["kernels"].double() - own["plain"].double())
                                          .abs().max()) / scale_free,
                "kernels_vs_f64": float((own["kernels"].double() - own["f64"]).abs().max())
                / scale_free,
                "plain_vs_f64": float((own["plain"].double() - own["f64"]).abs().max())
                / scale_free}
            rows.append(row)
            chain = y_plain
    return rows


def vjp_readings(model, inputs: dict) -> list:
    """Each block's input gradient, kernel route against plain route, on equal
    inputs (the plain chain) and an equal upstream gradient."""
    gen = torch.Generator().manual_seed(1)
    x = spliced(inputs, inputs["prompt"]).to(torch.bfloat16)
    x = x + model.positional_embedding[:x.shape[1]].to(x.dtype)
    rows = []
    for i, block in enumerate(model.transformer.resblocks):
        g = torch.randn(x.shape, generator=gen).to(x.device, x.dtype)
        grads = {}
        for route in ("kernels", "plain"):
            set_route(route)
            xi = x.detach().clone().requires_grad_(True)
            block(xi, True).backward(g)
            grads[route] = xi.grad.double()
        d = float((grads["kernels"] - grads["plain"]).abs().max())
        rows.append({"block": i, "max_abs": d, "max_grad": float(grads["plain"].abs().max()),
                     "bit_for_bit": bool(torch.equal(grads["kernels"], grads["plain"]))})
        set_route("plain")
        with torch.no_grad():
            x = block(x, True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/coop_grad_routes.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--layers", type=int, default=None, help="cut the tower (dry runs)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_coop_grad_routes: needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    dev = torch.device(args.device)
    bf16, _ = build_clip("ViT-L/14", torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                         device=dev)
    if args.layers:
        bf16.transformer.resblocks = bf16.transformer.resblocks[:args.layers]
    del bf16.visual
    models = {"bf16": bf16}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        models[name] = copy.deepcopy(bf16).to(dtype)
    inputs = coop_inputs(bf16, args.classes, dev)
    card = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    out = {"device": card, "classes": args.classes, "blocks": block_readings(models, inputs)}
    out["vjp"] = vjp_readings(bf16, inputs)
    grads = {}
    for route, model, dtype, remat in (("kernels", bf16, torch.bfloat16, False),
                                       ("plain", bf16, torch.bfloat16, False),
                                       ("f32", models["f32"], torch.float32, True),
                                       ("f64", models["f64"], torch.float64, True)):
        set_route("kernels" if route == "kernels" else "plain")
        grads[route] = loss_and_grad(model, inputs, dtype, remat)
    set_route("kernels")

    def pair(a, b):
        ga, gb = grads[a][1], grads[b][1]
        return {"grad_rel": float((ga - gb).norm() / gb.norm()),
                "grad_cos": float(torch.nn.functional.cosine_similarity(
                    ga.flatten(), gb.flatten(), dim=0)),
                "loss_rel": abs(grads[a][0] - grads[b][0]) / abs(grads[b][0])}

    out["grad"] = {"losses": {k: v[0] for k, v in grads.items()},
                   "kernels_vs_plain": pair("kernels", "plain"),
                   "kernels_vs_f64": pair("kernels", "f64"),
                   "plain_vs_f64": pair("plain", "f64"),
                   "f32_vs_f64": pair("f32", "f64")}
    out["seconds"] = time.perf_counter() - t0

    print(f"device: {card}; {args.classes} classes x 77 tokens, ViT-L/14 text tower "
          f"({len(bf16.transformer.resblocks)} blocks)")
    print("block  equal inputs: kern-plain  kern-f64  plain-f64 | free running: kern-plain  "
          "kern-f64  plain-f64   (max |d| / max |y|)")
    for r in out["blocks"]:
        e, f = r["equal_inputs"], r["free_running"]
        print(f"{r['block']:5d}  {e['kernels_vs_plain']:.3e} {e['kernels_vs_f64']:.3e} "
              f"{e['plain_vs_f64']:.3e} | {f['kernels_vs_plain']:.3e} {f['kernels_vs_f64']:.3e} "
              f"{f['plain_vs_f64']:.3e}")
    print("vjp on equal inputs, kernels vs plain: "
          + ", ".join(f"{r['block']}: {r['max_abs']:.2e}{' (equal)' if r['bit_for_bit'] else ''}"
                      for r in out["vjp"]))
    for k, v in out["grad"].items():
        print(f"grad {k}: {json.dumps(v)}")
    print(f"{out['seconds']:.1f} s")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
