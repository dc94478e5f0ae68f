"""What gloo does with CUDA tensors when two ranks share one card.

Two processes join a gloo group on ``cuda:0`` and try, in turn, all_reduce,
all_gather, broadcast, reduce_scatter and send/recv on CUDA tensors, each
checked against the answer. The PyTorch documentation lists reduce_scatter
and send/recv as CPU-only for gloo; a backend handed a device pointer may
raise, fail in its transport, or wait forever. So each rank reports the op it
starts before it starts it, the group's timeout is short, and the caller
kills both ranks after ``--timeout`` seconds; an op that never reports back
reads "no answer" (a hang or a crash). Prints one JSON line: op -> "ok",
"wrong values", the exception's first line, or "no answer".

Run: ``python tools/torch_gloo_probe.py [--timeout 60]`` (on the card).
"""

from __future__ import annotations

import argparse
import datetime
import json
import socket
import sys

OPS = ("all_reduce", "all_gather", "broadcast", "reduce_scatter", "send_recv")


def _rank(rank: int, port: int, queue) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=20))
    for op in OPS:
        queue.put((rank, op, "started"))
        x = torch.full((1024,), float(rank + 1), device="cuda")
        try:
            if op == "all_reduce":
                dist.all_reduce(x)
                ok = bool((x == 3).all())
            elif op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(2)]
                dist.all_gather(parts, x)
                ok = bool((parts[0] == 1).all() and (parts[1] == 2).all())
            elif op == "broadcast":
                dist.broadcast(x, src=0)
                ok = bool((x == 1).all())
            elif op == "reduce_scatter":
                out = torch.empty(512, device="cuda")
                dist.reduce_scatter(out, list(torch.full((1024,), 1.0, device="cuda").chunk(2)))
                ok = bool((out == 2).all())
            else:
                if rank == 0:
                    dist.send(x, dst=1)
                    ok = True
                else:
                    dist.recv(x, src=0)
                    ok = bool((x == 1).all())
            torch.cuda.synchronize()
            queue.put((rank, op, "ok" if ok else "wrong values"))
        except Exception as exc:   # the probe's answer is the exception
            queue.put((rank, op, f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"))
    dist.destroy_process_group()


def main(argv=None) -> int:
    import multiprocessing as mp
    import queue as queue_mod

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--timeout", type=float, default=60.0)
    args = parser.parse_args(argv)
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, queue), daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    answers = {}
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=args.timeout)
    while len([k for k, v in answers.items() if v != "started"]) < 2 * len(OPS):
        left = (deadline - datetime.datetime.now()).total_seconds()
        if left <= 0:
            break
        try:
            rank, op, what = queue.get(timeout=min(left, 1.0))
        except queue_mod.Empty:
            if not any(p.is_alive() for p in procs):
                break
            continue
        answers[rank, op] = what
    for p in procs:
        p.join(timeout=2)
        if p.is_alive():
            p.kill()
            p.join()
    out = {}
    for op in OPS:
        got = {answers.get((r, op), "not reached") for r in range(2)}
        got = {"no answer" if g == "started" else g for g in got}
        out[op] = got.pop() if len(got) == 1 else " / ".join(sorted(got))
    out["exit_codes"] = [p.exitcode for p in procs]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
