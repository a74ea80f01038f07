"""Training over a mesh with the train state placed a row shard a device
(``train.setup.place_train_state``, ``dist.packed.RowShards``), on the CPU.

The reference places the table, the row-wise adagrad accumulator, the
Eq. 7 priority and the access EMA with ``P(axis, None)`` / ``P(axis)``.
Its own train step cannot run at mesh > 1 under the installed JAX
(``tests/test_pipeline.py::test_compressed_step_mesh2_equivalent``), so
the port's placed step is held to the port's mesh-1 step bit for bit,
and mesh 1 to the reference's jitted step at ``test_torch_train.py``'s
tolerances (loss within 1e-5, priority bit for bit).  The CPU has one
device, so the placement over several cards is stood in for by shards
that are clones (``RowShards`` built from copies, no ``base``): a step
that read or wrote the whole leaf instead of its shards would fail
there.  The cards themselves: ``tests/test_torch_cuda.py::
*over_devices*``.
"""

from __future__ import annotations

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_dist_hashed
import torch_threads  # noqa: F401  (caps torch's CPU threads)

from repro import configs as jconfigs
from repro.train.setup import build_recsys_training as jbuild
from repro_torch import configs as tconfigs
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.convert import train_state_from_jax
from repro_torch.dist import hashed as tdh
from repro_torch.dist import make_mesh
from repro_torch.dist import packed as tdp
from repro_torch.launch import mesh as tlmesh
from repro_torch.launch import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.train.setup import build_recsys_training as tbuild

CPU = torch.device("cpu")
BATCH = 32
STEPS = 3


def bits(x) -> np.ndarray:
    x = tdp.whole(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def cloned(tree):
    """``tree`` with every tensor copied and every placed leaf rebuilt from
    copies of its shards through ``RowShards`` (no ``base``): the CPU's
    stand-in for shards on cards of their own."""
    if isinstance(tree, tdp.RowShards):
        return tdp.RowShards([s.clone() for s in tree.shards], tree.mesh,
                             tree.axis)
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cloned(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(cloned(x) for x in tree)
    if isinstance(tree, dict):
        return {k: cloned(v) for k, v in tree.items()}
    return tree


def leaves(state) -> dict:
    """The row-aligned leaves, the field score and the adagrad step."""
    return {"table": state.params["embed_table"], "adagrad": state.opt[1],
            "priority": state.priority, "access": state.accum.access,
            "field_score": state.accum.field_score,
            "emb_mean": state.accum.emb_mean}


def assert_state_equal(a, b) -> None:
    for k, x in leaves(a).items():
        np.testing.assert_array_equal(bits(x), bits(leaves(b)[k]),
                                      err_msg=k)


class _Largest(TorchDispatchMode):
    """The most elements any op's output holds while the mode is on."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.fixture(scope="module")
def ref():
    """The reference's dlrm-rm2 smoke setup and its jitted step."""
    jsetup = jbuild(jconfigs.get("dlrm-rm2"), batch=BATCH, use_pallas=True)
    return jsetup, jax.jit(jsetup.step)


def _setups(ref):
    """Mesh 1, mesh 4 with row views, mesh 4 with cloned shards, each from
    the reference's initial state."""
    jsetup, _ = ref
    arch = tconfigs.get("dlrm-rm2")
    out = {}
    for label, n in (("mesh1", 1), ("views", 4), ("clones", 4)):
        setup = tbuild(arch, batch=BATCH, device=CPU, model="smoke",
                       mesh=None if n == 1 else make_mesh(n, device="cpu"),
                       state=train_state_from_jax(jax.device_get(
                           jsetup.state)))
        state = cloned(setup.state) if label == "clones" else setup.state
        out[label] = [setup, state]
    return out


def _batch(nb: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in nb.items()}


def test_placed_step_bit_equal_to_mesh1_and_near_jax(ref):
    """(a) Three compressed steps at mesh 4, the state placed as row views
    and as cloned shards, against mesh 1: table, adagrad accumulator,
    priority, access EMA, field score, embedding mean and loss bit-equal;
    no op of a placed step makes a tensor as large as the (V, D) table.
    Mesh 1 against the reference's jitted step: loss within 1e-5,
    priority bit for bit."""
    jsetup, jstep = ref
    runs = _setups(ref)
    views = runs["views"][1]
    assert views.params["embed_table"].base is not None
    clones = runs["clones"][1]
    assert clones.params["embed_table"].base is None
    v, d = views.params["embed_table"].shape
    jstate = jsetup.state
    for s in range(STEPS):
        nb = jsetup.ds.batch(BATCH, s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(x) for k, x in nb.items()})
        loss = {}
        for label, run in runs.items():
            big = _Largest()
            with big:
                run[1], m = run[0].step(run[1], _batch(nb))
            loss[label] = float(m["loss"])
            if label != "mesh1":
                assert big.numel < v * d, (label, big.numel)
                placed = run[1].params["embed_table"]
                assert isinstance(placed, tdp.RowShards)
                assert (placed.base is None) == (label == "clones")
        assert loss["views"] == loss["mesh1"] == loss["clones"]
        for label in ("views", "clones"):
            assert_state_equal(runs[label][1], runs["mesh1"][1])
        want = float(jm["loss"])
        assert abs(loss["mesh1"] - want) <= 1e-5 * max(1.0, abs(want))
        np.testing.assert_array_equal(bits(runs["mesh1"][1].priority),
                                      bits(jstate.priority))


def _colliding_batch(setup, n: int) -> tuple[dict, int]:
    """A training batch in which, for every shard i >= 1, a slot another
    shard owns spreads (``spread_rows``: global row mod the shard's rows)
    onto the local row of a slot shard i owns: global rows g and
    g + i * stride in one sample.  Returns (batch, collisions)."""
    spec = setup.spec
    nb = setup.ds.batch(BATCH, 0)
    idx = np.array(nb["indices"])
    offs = np.asarray(spec.offsets(), np.int64)
    cards = np.asarray(spec.cardinalities, np.int64)
    stride = spec.total_rows // n

    def field_of(g):
        f = int(np.searchsorted(offs, g, side="right")) - 1
        return f if 0 <= g - offs[f] < cards[f] else None

    made = 0
    for b in range(BATCH):
        i = 1 + b % (n - 1)
        for f0 in range(spec.num_fields):
            g0 = int(offs[f0] + idx[b, f0])
            if g0 >= stride:
                continue
            f1 = field_of(g0 + i * stride)
            if f1 is not None and f1 != f0:
                idx[b, f1] = g0 + i * stride - offs[f1]
                made += 1
                break
    nb = dict(nb)
    nb["indices"] = idx
    return nb, made


def test_placed_step_with_colliding_slots_bit_equal_to_mesh1(ref):
    """(b) A batch where a masked-out slot's spread row equals an owned
    slot's row in the same shard, the int8 tier's stochastic snap on
    (every row starts at priority 0, the int8 tier): each shard writes
    only its own slots, so mesh 4 (views and clones) equals mesh 1 bit
    for bit after each of three steps."""
    runs = _setups(ref)
    setup = runs["mesh1"][0]
    nb, made = _colliding_batch(setup, 4)
    batch = _batch(nb)
    flat = setup.indices_fn(batch).reshape(-1, 1).to(torch.int64)
    table = runs["views"][1].params["embed_table"]
    plan = tdp.train_plan(flat, table.windows, table.mesh)
    hits = 0
    for li, m in zip(plan.local[1:], plan.mine[1:]):
        owned = set(li[m > 0].tolist())
        hits += sum(int(x) in owned for x in li[m == 0].tolist())
    assert made > 0 and hits > 0
    for _ in range(STEPS):
        loss = {}
        for label, run in runs.items():
            run[1], m = run[0].step(run[1], batch)
            loss[label] = float(m["loss"])
        assert loss["views"] == loss["mesh1"] == loss["clones"]
        for label in ("views", "clones"):
            assert_state_equal(runs[label][1], runs["mesh1"][1])


def _npz(directory: str) -> dict:
    step = CheckpointManager(directory).latest_step()
    path = os.path.join(directory, f"step_{step:010d}", "host_0.npz")
    with np.load(path) as data:
        return {k: np.array(data[k]) for k in data.files}


def test_checkpoint_of_a_placed_state_is_elastic(ref, tmp_path):
    """(c) A mesh-4 state (cloned shards) saved after two steps writes the
    arrays a mesh-1 save of the same state writes, key for key and bit for
    bit; restored onto mesh 2 and onto mesh 1, the next step equals the
    mesh-4 state's next step bit for bit."""
    jsetup, _ = ref
    runs = _setups(ref)
    del runs["views"]
    for s in range(2):
        batch = _batch(jsetup.ds.batch(BATCH, s))
        for run in runs.values():
            run[1], _ = run[0].step(run[1], batch)
    for label, run in runs.items():
        CheckpointManager(str(tmp_path / label)).save(2, run[1])
    a, b = _npz(str(tmp_path / "clones")), _npz(str(tmp_path / "mesh1"))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(bits(a[k]), bits(b[k]), err_msg=k)

    batch = _batch(jsetup.ds.batch(BATCH, 2))
    setup4, state4 = runs["clones"]
    want, wm = setup4.step(state4, batch)
    arch = tconfigs.get("dlrm-rm2")
    for n in (2, 1):
        setup = tbuild(arch, batch=BATCH, device=CPU, model="smoke",
                       mesh=None if n == 1 else make_mesh(n, device="cpu"))
        restored, step = CheckpointManager(str(tmp_path / "clones")).restore(
            setup.state)
        assert step == 2
        placed = restored.params["embed_table"]
        assert (isinstance(placed, tdp.RowShards)
                and placed.mesh.size == n) if n > 1 else isinstance(
                    placed, torch.Tensor)
        got, gm = setup.step(restored, batch)
        assert float(gm["loss"]) == float(wm["loss"])
        assert_state_equal(got, want)


def test_hashed_step_from_cloned_windows_near_mesh1_and_jax(monkeypatch):
    """(d) The hashed step at mesh 4 with each shard's window of the pool a
    copy (as on a card of its own), held as
    ``test_torch_dist_hashed.py::test_sharded_hashed_step_near_mesh1_and_
    jax`` holds the row views: priority and access EMA bit-equal to mesh
    1, loss and pool within 1e-5, against the reference at its
    tolerances."""
    copies = []

    def window(pool, first, rows, dev):
        copies.append(rows)
        return pool[first:first + rows].to(dev).clone()
    monkeypatch.setattr(tdh, "_window", window)
    test_torch_dist_hashed.test_sharded_hashed_step_near_mesh1_and_jax()
    assert len(copies) == 3 * 4


def test_device_lists_parse_and_absent_cards_raise(tmp_path):
    """(e) ``--device`` as a list: the train, serve and pipeline CLIs
    parse ``cpu,cpu --mesh 2`` (shard i on the i-th entry), a list whose
    length is not ``--mesh`` errors, a card that is not present raises
    (nothing falls back to fewer cards or to the CPU), and the pipeline
    over a list of several devices runs to its end.  The train CLI at
    ``--device cpu,cpu --mesh 2`` trains and checkpoints; the rerun at mesh
    1 resumes it, and its last loss equals a mesh-1 run's."""
    for cli in (ttrain, tserve, tpipe):
        args = cli.parse_args(["--device", "cpu,cpu", "--mesh", "2",
                               "--model", "smoke"])
        dev, mesh = tlmesh.mesh_from_args(args.device, args.mesh)
        assert dev == CPU and mesh.devices == (CPU, CPU)
        with pytest.raises(SystemExit):
            cli.parse_args(["--device", "cpu,cpu,cpu", "--mesh", "2"])
        with pytest.raises(SystemExit):
            cli.parse_args(["--device", "cpu,", "--mesh", "2"])
    assert tlmesh.mesh_from_args("cpu", 4)[1].devices == (CPU,) * 4
    assert tlmesh.mesh_from_args("cpu", 1) == (CPU, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tlmesh.mesh_from_args("cuda:7", 1)
        with pytest.raises(RuntimeError):
            tlmesh.mesh_from_args("cpu,cuda:7", 2)
    else:
        with pytest.raises(RuntimeError, match="not present"):
            tlmesh.mesh_from_args(
                f"cuda:{torch.cuda.device_count()}", 1)
    with pytest.raises(ValueError):
        tlmesh.mesh_from_args("cpu,cpu", 3)
    with contextlib.redirect_stdout(io.StringIO()):
        prec = tpipe.main(["--device", "cpu,cpu", "--mesh", "2", "--model",
                           "smoke", "--fast", "--ckpt-dir",
                           str(tmp_path / "p")])
    assert prec["devices"] == ["cpu", "cpu"] and prec["mesh"] == 2
    assert tpipe.verify_failures(prec) == [] and prec["reduced"] == []

    def train(argv):
        return ttrain.run(ttrain.parse_args(
            ["--model", "smoke", "--batch", "16", "--ckpt-every", "100"]
            + argv))
    rec = train(["--device", "cpu,cpu", "--mesh", "2", "--steps", "2",
                 "--ckpt-dir", str(tmp_path / "m")])
    assert rec["mesh"] == 2 and rec["devices"] == ["cpu", "cpu"]
    assert rec["reduced"] == [] and rec["device_peak_bytes_each"] == [0]
    resumed = train(["--device", "cpu", "--steps", "3",
                     "--ckpt-dir", str(tmp_path / "m")])
    assert resumed["resumed_from"] == 2 and resumed["steps_run"] == 1
    one = train(["--device", "cpu", "--steps", "3",
                 "--ckpt-dir", str(tmp_path / "one")])
    assert one["loss_last"] == resumed["loss_last"]


def test_serve_cli_over_a_device_list_as_mesh1():
    """The serve CLI at ``--device cpu,cpu --mesh 2`` (offline, smoke
    size): the store sharded over the list's two shards serves logits
    bit-equal to mesh 1's."""
    out = {}
    for argv in (["--device", "cpu"], ["--device", "cpu,cpu", "--mesh", "2"]):
        served = tserve.run(tserve.parse_args(
            ["--model", "smoke", "--requests", "2", "--batch", "64"]
            + argv))
        with torch.inference_mode():
            out[len(argv)] = tserve.serve_request(
                served.model, served.params, served.packed,
                served.make_request(0))
        assert served.record["mesh"] == (2 if len(argv) > 2 else 1)
    assert tserve.make_mesh_arg(tserve.parse_args(
        ["--device", "cpu,cpu", "--mesh", "2"])).devices == (CPU, CPU)
    np.testing.assert_array_equal(bits(out[2]), bits(out[4]))
