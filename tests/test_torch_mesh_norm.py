"""``chip_smoke.py``'s single-process grad norm in a mesh's order
(``mesh_order_norm``) against the ranks' own (``train/step.py:
_reduce_over_mesh``) on gloo CPU ranks at data 1 x model 2 and model 4.

The smoke holds the ranks of its mesh phase to a one-process step near bit
for bit; that reference clips by this norm, so both sides scale the
gradients alike. Each rank is a process of this file (``python
test_torch_mesh_norm.py --worker <rank> <world> <rendezvous file> <dir>``)
that imports only the port: it reduces its slices of seeded gradients of a
small DS2 and saves the norms. They equal the emulation's bit for bit on
every seed; the plain ``global_norm`` misses some of them, so the order
is what the test sees."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
RANK_ENV = dict(os.environ, OMP_NUM_THREADS="1")
SEEDS = 24


def _model():
    from deepspeech_tpu_torch.models import build_model

    model, _ = build_model("gru", 29, 64, 3, bidirectional=True,
                           compute_dtype="bfloat16", device="cpu")
    return model


def _grads(model, seed: int) -> list:
    """Gradients of ``model``'s shapes, each at a scale of its own."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(p.shape, generator=g) * torch.exp2(
        torch.randint(-8, 8, (), generator=g).float())
        for p in model.parameters()]


def _worker(rank, world, init, d):
    import datetime

    from deepspeech_tpu_torch.parallel import make_mesh
    from deepspeech_tpu_torch.parallel.mesh import param_spec, shard_dim
    from deepspeech_tpu_torch.train.step import _reduce_over_mesh

    torch.distributed.init_process_group(
        "gloo", init_method="file://" + init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(data=1, model=world, device=torch.device("cpu"))
        model = _model()
        dims = [shard_dim(param_spec(n, p.shape, world))
                for n, p in model.named_parameters()]
        norms = []
        for seed in range(SEEDS):
            mine = []
            for g, dim in zip(_grads(model, seed), dims):
                n = g.shape[dim] // world if dim is not None else 0
                mine.append(g if dim is None
                            else g.narrow(dim, rank * n, n).contiguous())
            norms.append(_reduce_over_mesh(
                mesh, mine, torch.zeros(()), torch.tensor(False),
                [dim is not None for dim in dims])[2])
        torch.save(torch.stack(norms), os.path.join(d, f"norms_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_order_norm_is_the_ranks_norm(tmp_path, world):
    sys.path.insert(0, ROOT)
    from chip_smoke import mesh_order_norm

    from deepspeech_tpu_torch.train.optim import global_norm

    init = os.path.join(tmp_path, "rdv")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(rank),
         str(world), init, str(tmp_path)], cwd=ROOT, env=RANK_ENV,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = [torch.load(os.path.join(tmp_path, f"norms_{r}.pt"))
             for r in range(world)]
    assert all(torch.equal(r, ranks[0]) for r in ranks)
    model = _model()
    norm = mesh_order_norm(torch, model, world)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' CPU sums, on one thread each
    try:
        emulated = torch.stack([norm(_grads(model, s))
                                for s in range(SEEDS)])
        plain = torch.stack([global_norm(_grads(model, s))
                             for s in range(SEEDS)])
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(emulated, ranks[0])
    assert not torch.equal(plain, ranks[0])


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, ROOT)
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
