"""Where a ClipGPT training micro-step's time goes (``chip_smoke.py``'s
train_gpt path), under ``torch.profiler``.

Runs on a CUDA card: ``python tools/torch_train_gpt_profile.py [--layers N]``
(about a minute on an H100). It tokenizes the synthetic corpus and runs
``apps.train_gpt`` as ``chip_smoke.run_train_gpt`` does (gpt2-large, bf16,
remat, batch 32 x 80, two updates), then profiles one micro-step (forward,
backward, the optimizer's call) with remat on and off, after two warm-up
micro-steps each. It prints the wall time of the profiled step, the sum of
the device kernels' own times (the card's busy time; the rest is the host
holding it back), the launches, and the operators ordered by device time and
by host time. ``--layers`` cuts the depth (the timed shapes stay full width).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from summer_clip_torch.apps.train_gpt import lm_loss_fn
    from summer_clip_torch.models import gpt2 as G
    from summer_clip_torch.ops import _lib

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--layers", type=int, default=36)
    args = parser.parse_args()
    if args.layers != 36:
        cfg = G.GPT2_CONFIGS["gpt2-large"]
        G.GPT2_CONFIGS["gpt2-large"] = G.GPT2Config(cfg.name, cfg.vocab_size, cfg.n_positions,
                                                    cfg.n_embd, args.layers, cfg.n_head)
    cs.log(f"card: {cs.card_line()}")
    _lib.build("attention_kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        trainer = cs.run_train_gpt(Path(tmp))["trainer"]
    model, tx = trainer.model, trainer.tx
    ids = torch.from_numpy(trainer.train_tokens[:cs.TRAIN_GPT_BATCH]).cuda()

    def micro():
        lm_loss_fn(model(ids)["logits"], ids).backward()
        tx.step()
        tx.zero_grad()

    for remat in (True, False):
        model.core.remat = remat
        for _ in range(2):
            micro()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            micro()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        cs.log(f"micro-step, remat {'on' if remat else 'off'}, {args.layers} layers: wall "
               f"{wall:.1f} ms under the profiler, device kernels {busy:.1f} ms in "
               f"{len(kernels)} launches ({busy / wall:.1%} busy)")
        table = prof.key_averages()
        print(table.table(sort_by="self_device_time_total", row_limit=15,
                          max_name_column_width=60))
        print(table.table(sort_by="self_cpu_time_total", row_limit=10, max_name_column_width=60))


if __name__ == "__main__":
    main()
