"""One process a mesh position (ROADMAP Queue 1 item 12(f)): the split
training step over ``torch.distributed`` against the one-process route,
on the CPU with ``gloo``.

A (d, m) mesh is d·m ranks (``tests/torch_dist_ranks.py``: spawned
processes, a group joined through a file under the test's directory,
each spawn with a deadline). Rank r is position (r // m, r % m); it
holds its own shards, computes its own data row and its own ``model``
share, and meets the others only through ``parallel.dist``'s
collectives, each followed by the one-process route's ordered sum. So on
(2, 1), (1, 2) and (2, 2), for all six families at
``tests/test_torch_train_model_split.py``'s reduced float32 sizes, two
steps give **bitwise** the one-process route's losses and grad norms on
``DeviceMesh`` of repeated ``"cpu"``, and every rank's shards of the
parameters, m and v are bitwise that route's shards at its position.
One spawn a mesh shape runs every family. Both routes run with one CPU
thread a process: a float32 product's rounding may depend on the thread
count. ``parallel.dist``'s collectives are held on their own: each
member's value arrives in position order and part k reaches member k.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.parallel.sharding import ShardedTensor
from repro_torch.train import optimizer as TO

torch.set_num_threads(1)   # as each rank: the products' rounding is kept

MESHES = [(2, 1), (1, 2), (2, 2)]


def cpu_mesh(data: int, model: int) -> DeviceMesh:
    grid = np.empty((data, model), dtype=object)
    grid.fill(torch.device("cpu"))
    return DeviceMesh(grid, ("data", "model"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{(d, m): [each rank's results]}, one spawn a mesh shape."""
    out = {}
    for data, model in MESHES:
        work = tmp_path_factory.mktemp(f"dist_{data}x{model}")
        R.run("families", data * model, work, model=model)
        out[data, model] = [torch.load(work / f"rank{r}.pt")
                            for r in range(data * model)]
    return out


@pytest.mark.parametrize("arch", R.ARCHS6)
@pytest.mark.parametrize("data,model", MESHES)
def test_process_route_is_the_one_process_route_bitwise(ranks, arch, data,
                                                        model):
    losses, norms, p, o = R.family_steps(arch, cpu_mesh(data, model))
    n_split = 0
    for r, got in enumerate(ranks[data, model]):
        got = got[arch]
        assert all(torch.equal(a, b) for a, b in zip(got["losses"], losses))
        assert all(torch.equal(a, b) for a, b in zip(got["norms"], norms))
        for name, tree in (("params", p), ("m", o.m), ("v", o.v)):
            for k, (a, x) in enumerate(zip(got[name], TO.leaves(tree))):
                split = isinstance(x, ShardedTensor)
                n_split += split
                want = x.shards[r] if split else x
                assert a.shape == want.shape and torch.equal(a, want), (
                    r, name, k)
    assert n_split >= 3 * data * model


@pytest.mark.parametrize("data,model", MESHES)
def test_the_collectives_each_route_uses(ranks, data, model):
    """Where each mesh's values meet: the data rows exchange gradients
    (all-to-all) only where there are rows to exchange between, and the
    ``model`` shares and the gathers of blocks all-gather."""
    for got in ranks[data, model]:
        counts = got["qwen2-0.5b"]["counts"]
        assert counts["all_gather"]["calls"] > 0
        assert (counts["all_to_all"]["calls"] > 0) == (data > 1)
        assert counts["gather"]["calls"] == counts["broadcast"]["calls"] \
            == 0


def test_collectives_keep_position_order(tmp_path):
    """On a (2, 2) mesh: each rank's subgroups, an all-gather over every
    rank (float32), over a data row (bfloat16) and of 0-d values, an
    all-to-all over a ``model`` column, a gather to rank 0, a broadcast
    from rank 1 and rank 0's outcome agreed by all."""
    R.run("collectives", 4, tmp_path, model=2)
    mine = [torch.arange(3, dtype=torch.float32) + 10 * r for r in range(4)]
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt")
        row, col = divmod(r, 2)
        assert got["position"] == (row, col)
        assert got["data"] == (col, 2 + col)
        assert got["model"] == (2 * row, 2 * row + 1)
        assert all(torch.equal(a, b)
                   for a, b in zip(got["world_gather"], mine))
        assert all(torch.equal(a, mine[k].bfloat16()) and a.dtype
                   == torch.bfloat16 for a, k in zip(
                       got["model_gather"], got["model"]))
        assert [float(x) for x in got["scalar_gather"]] == \
            [float(k) for k in got["data"]]
        assert all(torch.equal(a, mine[k] + 100 * row)
                   for a, k in zip(got["to_all"], got["data"]))
        if r == 0:
            assert all(torch.equal(a, b) for a, b in zip(got["gather"],
                                                         mine))
        else:
            assert got["gather"] is None
        assert torch.equal(got["broadcast"], mine[1])
        assert got["agree"] is True
        c = got["counts"]
        assert c["all_to_all"] == {"calls": 1, "bytes": 2 * 3 * 4}
        assert c["all_gather"]["calls"] == 3
        assert c["broadcast"]["calls"] == 2
        assert c["gather"]["calls"] == (1 if r == 0 else 0)
