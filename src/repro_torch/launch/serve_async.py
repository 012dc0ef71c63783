"""Async serving front door: streamed tokens over a line-JSON socket.

``python -m repro_torch.launch.serve_async --arch stablelm-1.6b --demo 4``

Mirror of ``repro/launch/serve_async.py``.  Runs an
:class:`~repro_torch.serving.frontdoor.AsyncFrontDoor` over a paged engine
(or a prefill/decode ``DisaggController`` with ``--disagg``) and serves it
two ways:

* ``--demo N``: no sockets; submit an N-request mixed-length trace through
  the door and print each request's tokens as they stream.
* default: an asyncio TCP server speaking newline-delimited JSON.  Each
  request line ``{"prompt": [ints], "max_new_tokens": N, "slo":
  "standard", "deadline_s": 0.5}`` is answered with one ``{"rid": r}``
  ack, a ``{"rid": r, "token": t}`` line per generated token as the engine
  commits it, and a final ``{"rid": r, "done": true, "reason": ...}``.
  ``examples/stream_client.py`` is the matching client.

The model is the reduced-width configuration with seeded random weights,
as in ``launch/serve.py``; it runs on the CUDA card unless ``--device
cpu`` asks for the plain PyTorch path.  Wall-clock deadlines
(``deadline_s``) map onto the engine's tick-indexed QoS through the
:class:`~repro_torch.serving.frontdoor.SlaMapper`, fed with tick timings
from an injected ``SystemClock``; ``serving/`` itself reads no wall clock.

Graceful shutdown: SIGINT/SIGTERM stop admissions and, with
``--snapshot-dir``, persist the engine through the checkpoint store
(``shutdown("snapshot")``); relaunching with the same directory restores,
and every interrupted stream replays from token zero.  Without a snapshot
directory the door drains: everything accepted is served to the end.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as T
from repro_torch.runtime import SystemClock
from repro_torch.serving import PagedEngine, ServeConfig
from repro_torch.serving.frontdoor import (AsyncFrontDoor, DisaggController,
                                           SlaMapper)


def build_door(args):
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch).replace(
        attn_impl="bitstopper_xla",
        bitstopper=BitStopperConfig(alpha=args.alpha))
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_model(cfg, gen, device)

    def engine(slots):
        return PagedEngine(cfg, params, ServeConfig(
            max_len=args.max_prompt + args.new_tokens + 8,
            max_slots=slots, prefill_bucket=8,
            temperature=args.temperature,
            fused_decode={"auto": None, "on": True, "off": False}[
                args.fused_decode]), device=device)

    if args.disagg:
        if args.snapshot_dir is not None:
            raise SystemExit("--snapshot-dir needs a colocated engine "
                             "(--disagg drains instead)")
        backend = DisaggController(engine(max(1, args.slots // 2)),
                                   engine(args.slots))
    else:
        backend = engine(args.slots)
    clock = SystemClock()
    door = AsyncFrontDoor(backend, clock=clock,
                          sla=SlaMapper(granularity=clock.granularity),
                          snapshot_dir=args.snapshot_dir, seed=args.seed)
    return cfg, door


async def serve_socket(args, door):
    async def handle(reader, writer):
        async def pump(rid):
            async for tok in door.stream(rid):
                writer.write(json.dumps(
                    {"rid": rid, "token": tok}).encode() + b"\n")
                await writer.drain()
            req = door.result(rid)
            reason = (req.shed_reason if req.shed_reason is not None
                      else "deadline" if req.deadline_hit else "done")
            writer.write(json.dumps(
                {"rid": rid, "done": True, "reason": reason,
                 "tokens": [int(t) for t in req.generated]}).encode()
                + b"\n")
            await writer.drain()

        pumps = []
        try:
            async for line in reader:
                msg = json.loads(line)
                try:
                    rid = door.submit(
                        np.asarray(msg["prompt"], np.int32),
                        max_new_tokens=int(msg.get("max_new_tokens", 32)),
                        slo=msg.get("slo", "standard"),
                        deadline_s=msg.get("deadline_s"))
                except (RuntimeError, ValueError) as e:
                    writer.write(json.dumps(
                        {"error": str(e)}).encode() + b"\n")
                    await writer.drain()
                    continue
                writer.write(json.dumps({"rid": rid}).encode() + b"\n")
                await writer.drain()
                pumps.append(asyncio.create_task(pump(rid)))
        finally:
            if pumps:
                await asyncio.gather(*pumps, return_exceptions=True)
            writer.close()

    server = await asyncio.start_server(handle, args.host, args.port)
    runner = asyncio.create_task(door.run())
    loop = asyncio.get_running_loop()
    mode = "snapshot" if args.snapshot_dir is not None else "drain"
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, door.shutdown, mode)
    addr = server.sockets[0].getsockname()
    print(f"serving on {addr[0]}:{addr[1]} "
          f"(shutdown mode on signal: {mode})", flush=True)
    await runner                      # returns on a drain or snapshot stop
    server.close()
    await server.wait_closed()
    print(f"stopped after {door.ticks_run} ticks; "
          f"admitted {len(door.admission_log)} request(s)"
          + (f"; {len(door.interrupted)} stream(s) snapshotted for resume"
             if door.interrupted else ""))


async def run_demo(args, door, cfg):
    restored = door.start()
    rng = np.random.default_rng(args.seed)
    rids = []
    if restored:
        print(f"restored snapshot; resuming "
              f"{len(door.backend.requests)} in-flight request(s)")
        rids = sorted(door.backend.requests)
    else:
        slos = ("strict", "standard", "besteffort")
        for i in range(args.demo):
            prompt = rng.integers(
                0, cfg.vocab,
                int(rng.integers(args.min_prompt, args.max_prompt + 1)),
                dtype=np.int32)
            rids.append(door.submit(prompt, args.new_tokens,
                                    slo=slos[i % len(slos)],
                                    deadline_s=args.deadline_s))
    runner = asyncio.create_task(door.run())
    results = {}

    async def show(rid):
        toks = []
        async for tok in door.stream(rid):
            toks.append(tok)
        req = door.result(rid)
        status = (req.shed_reason or
                  ("deadline" if req.deadline_hit else "done"))
        results[rid] = toks
        print(f"  rid {rid} [{req.slo:>10}] {status}: {toks}")

    streams = asyncio.gather(*(show(r) for r in rids))
    door.shutdown("drain")
    await streams
    await runner
    print(f"admission order: {door.admission_log} "
          f"({door.ticks_run} engine ticks)")
    if door.sla.tick_estimate:
        print(f"measured tick: {door.sla.tick_estimate * 1e3:.1f} ms")
    return results


def main(argv=None):
    """Run the demo or the socket server; the demo returns each rid's
    streamed tokens."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--alpha", type=float, default=0.6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--fused-decode", default="auto",
                    choices=["auto", "on", "off"])
    ap.add_argument("--disagg", action="store_true",
                    help="two-instance mode: a prefill engine hands "
                         "detached prefixes to the decode engine through "
                         "the transfer queue")
    ap.add_argument("--snapshot-dir", default=None,
                    help="persist engine state on signalled shutdown; "
                         "relaunching restores and interrupted streams "
                         "replay from token zero")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="demo mode: per-request wall-clock deadline, "
                         "mapped to engine ticks by the SLA mapper")
    ap.add_argument("--demo", type=int, default=0, metavar="N",
                    help="self-driving mode: stream an N-request trace "
                         "to stdout instead of opening a socket")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8763)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg, door = build_door(args)
    if args.demo:
        return asyncio.run(run_demo(args, door, cfg))
    door.start()
    asyncio.run(serve_socket(args, door))
    return None


if __name__ == "__main__":
    main()
