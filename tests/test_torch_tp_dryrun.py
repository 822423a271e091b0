"""The port's dry-run over meshes with a "model" axis: the port of the JAX
package's ``tests/test_launch.py::test_mini_dryrun_8dev``.

``launch/dryrun.py`` builds the mesh step of each cell and runs it on the
meta device with rank 0's view of a stand-in process group of every rank
(torch's ``"fake"`` backend), in spawned worker processes (``run_cells``
with jobs, so that no process group of this process is in the way).  The
JAX package's six (arch, kind) pairs, reduced, at seq 16 and batch 8:

* at 4 x 2 (data, model) every cell is OK, with the collectives the step
  makes counted; the two decode cells (hymba-1.5b, xlstm-350m) take the
  rank's chunks of the caches as ``cache_shardings`` places them, and
  count all-gathers (q and the new row's k and v over "model", the
  partials' combine, the recurrent states' reshards);
* at 1 x 1 every cell is OK, decode included, with no collective;
* at 2 x 2 x 2 (pod, data, model) a train cell counts what 4 x 2 counts:
  the pod and data axes together are its batch group.

The train cells count Megatron-TP's step (``seq_shard=False``, the
dry-run's ``--no-seq-shard``); ``tests/test_torch_tp_seq.py`` counts the
default, sequence-parallel one.
"""
import pytest

from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import MESHES, mesh_axes, run_cells

PAIRS = (("smollm-360m", "train"), ("granite-moe-3b-a800m", "train"),
         ("hymba-1.5b", "decode"), ("deepseek-v2-lite-16b", "prefill"),
         ("xlstm-350m", "decode"), ("musicgen-medium", "train"))
GRIDS = ((4, 2), (1, 1), (2, 2, 2))


@pytest.fixture(scope="module")
def records():
    todo = [(arch, InputShape("t", 16, 8, kind),
             {"mesh_shape": grid, "reduced": True, "seq_shard": False})
            for grid in GRIDS for arch, kind in PAIRS
            if grid != (2, 2, 2) or arch == "smollm-360m"]
    got = run_cells(todo, jobs=3)
    return {(t[0], t[2]["mesh_shape"]): c for t, c in zip(todo, got)}


@pytest.mark.parametrize("arch,kind", PAIRS)
def test_mini_dryrun_over_a_model_axis(arch, kind, records):
    cell = records[(arch, (4, 2))]
    assert cell["mesh"] == "4x2" and cell["kind"] == kind
    assert cell["status"] == "OK", cell.get("traceback")
    assert cell["n_devices"] == 8 and cell["local_batch"] == 2
    cc, cb = cell["collective_count"], cell["collective_bytes"]
    # the model group's f and g, the batch group's gradient all-reduce
    # (and, train with FSDP, the "embed" gathers)
    assert cc["all-reduce"] > 0 and cb["all-reduce"] > 0
    if kind == "decode":
        assert cc["all-gather"] > 0 and cb["all-gather"] > 0
    assert cell["total_collective_bytes"] == sum(cb.values())
    assert cell["flops"] > 0 and cell["memory"]["peak_bytes"] > 0


@pytest.mark.parametrize("arch,kind", PAIRS)
def test_mini_dryrun_on_one_rank(arch, kind, records):
    cell = records[(arch, (1, 1))]
    assert cell["status"] == "OK", cell.get("traceback")
    assert cell["total_collective_bytes"] == 0
    assert set(cell["collective_bytes"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}


def test_a_pod_axis_is_part_of_the_batch_group(records):
    two, three = records[("smollm-360m", (4, 2))], records[
        ("smollm-360m", (2, 2, 2))]
    assert three["status"] == "OK", three.get("traceback")
    assert three["mesh"] == "2x2x2" and three["local_batch"] == 2
    assert three["collective_bytes"] == two["collective_bytes"]
    assert three["collective_count"] == two["collective_count"]
    assert MESHES == {"single": (16, 16), "multi": (2, 16, 16)}
    assert mesh_axes((2, 16, 16)) == ("pod", "data", "model")
