"""Multi-process pricing over a (processes x devices) mesh.

The CUDA reference is single-GPU; single-process multi-device
scale-out lives in nmch/parallel/mesh.py.  This example wires the
remaining layer — `jax.distributed` across processes — so the same
`sharded_moments` call prices over every GPU of every process (Monte
Carlo needs ONE 2-float psum at the end, so inter-host latency is
irrelevant).

One process per GPU on one machine (process i owns card i):

    python examples/multihost.py --gpu --processes 4 --port 9731

Across machines, run one process per card with the same coordinator
(``host:port`` of process 0) and a distinct --process-id and
--local-device-id on each.  Or simulate 2 processes x 4 virtual CPU
devices on one machine:

    python examples/multihost.py --cpu --processes 2 --port 9731

(the CPU form is what tests/test_multihost.py runs).

Design notes (SURVEY.md §5 "distributed communication backend"):
* paths are sharded over a 1-D global mesh covering all devices of
  all processes — each device owns a disjoint stream range (base_path
  offset), so an n-process run draws exactly the same per-path
  randomness as a single-device run of the same (seed, epoch);
* `sharded_moments` takes ANY jax.sharding.Mesh: a multi-host mesh
  changes only the device array, not the code;
* the final psum is the only cross-process traffic (8 bytes/device).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def worker(args, process_id: int | None = None) -> None:
    import jax

    coordinator = args.coordinator or f"localhost:{args.port}"
    if args.cpu:
        # the CPU backend with N virtual devices per process, set
        # BEFORE distributed init
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.local_devices)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=args.processes,
            process_id=process_id)
    else:
        # one card per process; nothing on the machine describes the
        # cluster, so every field is given explicitly
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=args.processes,
            process_id=process_id,
            local_device_ids=[args.local_device_id
                              if args.local_device_id is not None
                              else process_id])

    from nmch.params import HestonParams
    from nmch.parallel.mesh import make_mesh, sharded_moments

    devices = jax.devices()          # GLOBAL device list (all hosts)
    mesh = make_mesh(devices)
    params = HestonParams()
    n_paths = args.paths_per_device * len(devices)

    m, m2 = sharded_moments(
        mesh, params.as_array(), seed=1234, epoch=0,
        N=args.N, n_paths=n_paths, method=args.method, engine=args.engine,
        rng=args.rng, conditional=args.conditional, interpret=args.cpu)
    if jax.process_index() == 0:
        print(f"processes={jax.process_count()} devices={len(devices)} "
              f"paths={n_paths} {args.method}/{args.engine}: "
              f"price={float(m):.9f} "
              f"(E[X^2]={float(m2):.6f})", flush=True)
    jax.distributed.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--cpu", action="store_true",
                      help="simulate multi-host with CPU processes")
    mode.add_argument("--gpu", action="store_true",
                      help="launch one process per local GPU")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (default: "
                         "localhost:--port)")
    ap.add_argument("--local-device-id", type=int, default=None,
                    help="the card this process owns (default: its "
                         "process id)")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--port", type=int, default=9731)
    ap.add_argument("--paths-per-device", type=int, default=1024)
    ap.add_argument("--N", type=int, default=50)
    ap.add_argument("--method", choices=["fe", "em"], default="fe")
    ap.add_argument("--engine", choices=["scan", "pallas", "qmc"],
                    default="scan")
    ap.add_argument("--rng", default="philox",
                    help="stream family (incl. the stateful pair "
                         "mrg32k3a/xorwow — their skip-ahead shards "
                         "across processes like the counter rngs)")
    ap.add_argument("--conditional", action="store_true",
                    help="EM: closed-form conditional payoff")
    ap.add_argument("--process-id", type=int, default=None,
                    help="(internal) set by the CPU-mode launcher")
    args = ap.parse_args()

    if (args.cpu or args.gpu) and args.process_id is None:
        # launcher: spawn one subprocess per simulated host / local card
        import subprocess
        procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--cpu" if args.cpu else "--gpu",
                              f"--processes={args.processes}",
                              f"--local-devices={args.local_devices}",
                              f"--port={args.port}",
                              f"--paths-per-device={args.paths_per_device}",
                              f"--N={args.N}",
                              f"--method={args.method}",
                              f"--engine={args.engine}",
                              f"--rng={args.rng}",
                              *(["--conditional"] if args.conditional
                                else []),
                              f"--process-id={i}"])
            for i in range(args.processes)]
        rc = max(p.wait() for p in procs)
        return rc

    worker(args, process_id=args.process_id)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
