"""One process per rank for the CLIs' ``--mesh N``.

``mesh_main`` decides how a CLI runs its ranks; ``launch_ranks`` starts ``python -m smpltpu_torch.parallel.launch`` once a
rank; each worker joins the mesh through a ``FileStore`` in a directory
of its own under the run's output directory (no network) and calls the
CLI's ``main(argv, device=..., mesh=...)`` as that rank. Rank 0's output
is passed on when the ranks end, and every rank's error output; the other
ranks' standard output (the same lines as rank 0's) is dropped. A rank
that fails ends the others.
"""

from __future__ import annotations

import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from smpltpu_torch.parallel.mesh import FramesMesh, frames_mesh, mesh_size

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def launch_ranks(module: str, argv: list, n: int, device, workdir: str) -> int:
    """Run ``module.main`` (a CLI of the port) as n ranks on ``device``,
    one process each; the first non-zero exit code of a rank, else 0."""
    run_dir = tempfile.mkdtemp(prefix=".mesh_", dir=workdir)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                          if p])
    if torch.device(device).type == "cpu":
        env["OMP_NUM_THREADS"] = str(max(1, torch.get_num_threads() // n))
    procs, logs = [], []
    try:
        for r in range(n):
            out = open(os.path.join(run_dir, f"rank{r}.out"), "w+")
            err = open(os.path.join(run_dir, f"rank{r}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "smpltpu_torch.parallel.launch",
                 module, str(r), str(n), str(device),
                 os.path.join(run_dir, "store"), "--"] + list(argv),
                stdout=out, stderr=err, stdin=subprocess.DEVNULL, env=env))
        rc = 0
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            if p.returncode and not rc:
                rc = p.returncode
        for r, (out, err) in enumerate(logs):
            out.seek(0)
            err.seek(0)
            if r == 0:
                sys.stdout.write(out.read())
            text = err.read()
            if text and (r == 0 or procs[r].returncode):
                sys.stderr.write(text if r == 0 else f"[rank {r}] {text}")
        sys.stdout.flush()
        sys.stderr.flush()
        return rc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()
        shutil.rmtree(run_dir, ignore_errors=True)


def mesh_main(run, module: str, argv: list, n: int, device, workdir: str,
              mesh=None) -> int:
    """A CLI's body ``run(mesh)`` as ``--mesh n`` asks: as ``mesh``'s rank
    when one is given (a worker, or a test's thread); without a mesh for n
    <= 1; as the one rank of a mesh in this process when the device holds
    one rank (one card); else a process a rank (``launch_ranks``)."""
    if mesh is not None or n <= 1:
        return run(mesh)
    ranks = mesh_size(n, device)
    if ranks > 1:
        os.makedirs(workdir, exist_ok=True)
        return launch_ranks(module, argv, ranks, device, workdir)
    with frames_mesh(1, device) as one:
        return run(one)


def _worker(module, rank, size, device, store_path, argv) -> int:
    from torch.distributed import FileStore

    with FramesMesh(FileStore(store_path, size), rank, size, device) as mesh:
        return importlib.import_module(module).main(
            argv, device=str(mesh.device), mesh=mesh)


if __name__ == "__main__":
    # python -m smpltpu_torch.parallel.launch <module> <rank> <size>
    #     <device> <store path> -- <argv...>
    a = sys.argv[1:]
    if len(a) < 6 or a[5] != "--":
        raise SystemExit("usage: python -m smpltpu_torch.parallel.launch "
                         "<module> <rank> <size> <device> <store> -- argv")
    sys.exit(_worker(a[0], int(a[1]), int(a[2]), a[3], a[4], a[6:]))
