"""One rank of the port's multi-process tests (tests/test_torch_parallel.py).

    python tests/torch_dist_worker.py PORT RANK WORLD JOBS OUT_DIR

Joins a gloo process group through clsim_tpu_torch.parallel.bootstrap's
explicit branch (tcp://127.0.0.1:PORT), builds the photon mesh on the CPU,
runs every job of JOBS (a torch.save'd dict written by the test process:
name -> job) and writes OUT_DIR/<name>.rank<RANK>.npz.  Imports torch and
clsim_tpu_torch only; a job "meta" records the backend, the mesh and that
neither jax nor clsim_tpu was imported.
"""

import os
import sys

import numpy as np
import torch


def run_propagate(job, mesh):
    from clsim_tpu_torch.parallel.bootstrap import process_step_slice
    from clsim_tpu_torch.parallel.mesh import (make_sharded_propagate,
                                               shard_steps)
    from clsim_tpu_torch.types import StepBatch
    steps = job["steps"]
    if job.get("feed") == "process_step_slice":
        sl = process_step_slice(int(steps.x.shape[0]))
        local = StepBatch(*[f[sl] for f in steps])
    else:
        local = shard_steps(steps, mesh)
    run = make_sharded_propagate(
        mesh, job["cfg"], backend=job["backend"], medium=job["medium"],
        geo=job["geo"], spectra=job["spectra"],
        with_uniforms="uniforms" in job, **job.get("opts", {}))
    extra = (job["uniforms"],) if "uniforms" in job else ()
    res = run(local, job["medium"], job["geo"], job["spectra"], job["key"],
              *extra)
    out = dict(hist=res.hist.numpy(), n_generated=float(res.n_generated),
               n_hits=float(res.n_hits), weight_hits=float(res.weight_hits),
               n_iterations=res.n_iterations, backend=run.backend,
               reason=str(run.backend_reason))
    if res.diag_totals is not None:
        out["diag_totals"] = res.diag_totals.numpy()
    return out


def run_run_steps(job, mesh):
    from clsim_tpu_torch.api import Simulation
    sim = Simulation(medium=job["medium"], geometry=job["geo"],
                     config=job["cfg"], mesh=mesh, use_native=False)
    res = sim.run_steps(job["batches"], job["seed"])
    return dict(hist=res.hist.numpy(), n_generated=float(res.n_generated),
                n_hits=float(res.n_hits), weight_hits=float(res.weight_hits),
                backend=sim._propagate.backend)


def run_fit(job, mesh):
    from clsim_tpu_torch.parallel.mesh import IceFit, shard_steps
    fit = IceFit(job["cfg"], job["geo"], job["spectra"], mesh=mesh,
                 **job["fit"])
    params, loss = fit.step(job["params"], job["medium"],
                            shard_steps(job["steps"], mesh), job["key"],
                            job["target"])
    return dict(loss=float(loss),
                **{f"param_{k}": v.numpy() for k, v in params.items()})


def main():
    port, rank, world, jobs_path, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from clsim_tpu_torch.parallel.bootstrap import (global_photon_mesh,
                                                    initialize_distributed)
    ok = initialize_distributed(f"tcp://127.0.0.1:{port}", world_size=world,
                                rank=rank)
    mesh = global_photon_mesh(device="cpu")
    # the jobs file is written by the test process that started this one
    jobs = torch.load(jobs_path, weights_only=False)
    runners = dict(propagate=run_propagate, run_steps=run_run_steps,
                   fit=run_fit)
    for name, job in jobs.items():
        out = runners[job["kind"]](job, mesh)
        np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"), **out)
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                            "clsim_tpu")]
    np.savez(os.path.join(out_dir, f"meta.rank{rank}.npz"),
             initialized=ok, backend=dist.get_backend(), rank=mesh.rank,
             size=mesh.size, leaked=np.asarray(leaked, dtype=str))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
