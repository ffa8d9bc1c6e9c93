"""One rank of ``tests/test_torch_seq_pipe.py``'s gloo runs (not a test file).

    python tests/torch_seq_pipe_worker.py RANK WORLD STORE CASES OUT

Starts a gloo process group of WORLD ranks from the ``file://`` STORE, runs
every case of the pickle CASES through the port (imports no jax) and
pickles this rank's results to ``OUT/rank{RANK}.pkl``. A case of kind
``"ring"`` runs ``ring_attention`` alone: ``q``, ``k``, ``v`` and ``do``
are whole ``[B, H, S, D]`` numpy arrays and ``mesh`` puts ``sp`` over the
world; the rank returns its block of the output and of the three
gradients (the backward of ``sum(o * do)``), and the transport of the
shift. Every other case is one of ``tests/torch_parallel_worker.py``'s.
"""

import pickle
import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel import MeshSpec, make_mesh, p2p_transport

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_worker  # noqa: E402  (beside this file)


def ring_case(case: dict) -> dict:
    mesh = make_mesh(MeshSpec(**case["mesh"]), "cpu")
    sp, r = mesh.size("sp"), mesh.coordinate("sp")
    n = case["q"].shape[2] // sp

    def block(a):
        return torch.from_numpy(a[:, :, r * n:(r + 1) * n].copy())

    q, k, v = (block(case[x]).requires_grad_() for x in "qkv")
    o = ring_attention(q, k, v, mesh)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), block(case["do"]))
    return dict(coord=r, o=o.detach().numpy(), dq=dq.numpy(), dk=dk.numpy(), dv=dv.numpy(),
                transport=p2p_transport(mesh, "sp", q.device))


def main(rank: int, world: int, store: str, cases_path: str, out_dir: str) -> None:
    torch.manual_seed(0)
    torch_parallel_worker.common._unpack = torch_parallel_worker._counting_unpack
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        with open(cases_path, "rb") as f:
            cases = pickle.load(f)
        results = {
            c["name"]: ring_case(c) if c["kind"] == "ring" else torch_parallel_worker.run_case(c)
            for c in cases
        }
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        rank, world, store, cases_path, out_dir = sys.argv[1:]
        main(int(rank), int(world), store, cases_path, out_dir)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
