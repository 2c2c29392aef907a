"""The seven baseline families on the port's (dp, mp) mesh against one
process, on the CPU.

One world of four spawned ranks over Gloo (dp=2, mp=2; as
tests/test_torch_mesh.py spawns them) steps every family in turn through
`parallel/programs.py::chunk_program` — one train chunk from the Trainer's
seed, a train summary, an evaluation and a save — then serves each save
with `serve_program`.  Catalog sizes are not multiples of mp, so every
vocab table pads.  One process runs the same on the CPU; the mesh must
equal it: losses, metrics within 1e-5 (tests/test_mesh_trainer.py:57-59),
every unpadded parameter, the summary, and the meshed Recommender's
answers."""

import numpy as np
import pytest
import torch

from tests.test_torch_family_paths import FAMILIES, cfg_kw, family_data
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data.batcher import epoch_index
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.parallel import programs
from tlsan_tpu_torch.parallel.multihost import run_local
from tlsan_tpu_torch.serve.recommender import Recommender
from tlsan_tpu_torch.train.loop import Trainer

DP, MP = 2, 2
# the world runs for about 20 s alone; the limit fails a hang long
# before the suite's
WORLD_TIMEOUT_S = 240
USERS, ITEMS, CATES = 21, 29, 5  # none a multiple of mp: the tables pad
N_TRAIN, N_TEST = 64, 40
TRAIN_KW = dict(max_epochs=1, train_batch_size=32, test_batch_size=16,
                steps_per_call=2, best_after_step=0, learning_rate=0.5,
                save_auc_gate=0.0)
TOL = 1e-5
K_LSPM = 5


def _cfg(name):
    return ModelConfig(**cfg_kw(name, user_count=USERS, item_count=ITEMS,
                                cate_count=CATES))


def _data(name):
    _, _, train, test, cate_list = family_data(name, N_TRAIN, N_TEST, seed=8,
                                               users=USERS, items=ITEMS, cates=CATES)
    if name == "shan":
        # mostly short sessions, so the dp shards of a batch differ in
        # their longest: SHAN's softmax width is the global batch's
        rng = np.random.default_rng(9)
        for b in (train, test):
            for ids, sl in (("hist_i", "sl"), ("hist_i_new", "sl_new")):
                keep = rng.random(b.n) < 0.05
                b.arrays[sl] = np.where(keep, b[sl], np.minimum(b[sl], 2)).astype(np.int32)
                cols = np.arange(b[ids].shape[1])[None, :]
                b.arrays[ids] = np.where(cols < b[sl][:, None], b[ids], 0).astype(np.int32)
    return train, test, cate_list


def _requests(name, test):
    """The test set's histories as serving requests (no target)."""
    drop = ("j",) if name == "csan" else ("i", "j")
    return {k: v[:30] for k, v in test.arrays.items() if k not in drop}


IDX = epoch_index(N_TRAIN, 32, 2, 0, 1234)[0]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    jobs = []
    for name in FAMILIES:
        train, test, cate_list = _data(name)
        tc = TrainConfig(model_dir=str(tmp / name), dp=DP, mp=MP, **TRAIN_KW)
        jobs.append((programs.chunk_program, dict(
            cfg=_cfg(name), tc=tc, cate_list=cate_list, train=train, test=test,
            idx=IDX)))
        jobs.append((programs.serve_program, dict(
            model_dir=tc.model_dir, cate_list=cate_list,
            requests=_requests(name, test), k=10, batch_size=16)))
    # LSPM's right-aligned window through the host-side history filter
    train, test, cate_list = _data("lspm")
    jobs.append((programs.serve_program, dict(
        model_dir=str(tmp / "lspm"), cate_list=cate_list,
        requests=_requests("lspm", test), k=10, batch_size=16,
        exclude_history=True)))
    got = run_local(programs.sequence, DP, MP, "gloo", "cpu", WORLD_TIMEOUT_S, *jobs,
                    init_method="file://" + str(tmp / "rendezvous"))
    return tmp, got


@pytest.mark.parametrize("name", FAMILIES)
def test_family_on_the_mesh_equals_one_process(world, name):
    tmp, got = world
    i = FAMILIES.index(name)
    ranks = [r[2 * i] for r in got]
    train, test, cate_list = _data(name)
    tc = TrainConfig(model_dir=str(tmp / f"{name}_one"), **TRAIN_KW)
    one = Trainer(get_model(name), _cfg(name), tc, cate_list, train, test, device="cpu")
    chunk = torch.from_numpy(IDX)
    losses = one._train_chunk(chunk).numpy()
    rows, l2 = one._summaries(chunk[-1])
    metrics = one.evaluate()
    state = {k: v.detach().numpy() for k, v in one.model.state_dict().items()}
    one.close()

    for r in ranks:  # every rank reads the global losses and metrics
        np.testing.assert_allclose(r["losses"], losses, rtol=TOL, atol=TOL)
        assert r["metrics"].keys() == metrics.keys()
        for k in metrics:
            assert abs(r["metrics"][k] - metrics[k]) < TOL, (k, r["metrics"][k], metrics[k])
        got_rows, want_rows = r["summary"]["rows"], rows.numpy()
        np.testing.assert_allclose(got_rows[:, :5], want_rows[:, :5], rtol=TOL, atol=TOL)
        # bucket counts: a value within rounding of a bucket edge may land
        # on either side of it, so counts agree to a few moves a row
        moved = np.abs(got_rows[:, 5:] - want_rows[:, 5:]).sum(1)
        assert (moved <= 4).all(), moved
        np.testing.assert_allclose(r["summary"]["l2"], float(l2), rtol=TOL)
        assert r["launches"]["chunk"] == r["launches"]["evaluate"] == {
            "fwa_fwd": 0, "fwa_bwd": 0, "mha_fwd": 0, "mha_bwd": 0}
    assert ranks[0]["pad_max"] == 0.0
    mesh_state = ranks[0]["state"]
    assert mesh_state.keys() == state.keys()
    for k in state:
        np.testing.assert_allclose(mesh_state[k], state[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", FAMILIES + ["lspm_exclude"])
def test_meshed_recommender_equals_one_device(world, name):
    """Every rank returns the whole answer, equal to the single-device
    Recommender's on the mesh's save: scores within 1e-5, the same ids up
    to ties; for lspm_exclude, with LSPM's right-aligned history
    excluded."""
    tmp, got = world
    exclude = name == "lspm_exclude"
    name = "lspm" if exclude else name
    ranks = [r[-1 if exclude else 2 * FAMILIES.index(name) + 1] for r in got]
    for r in ranks[1:]:
        assert r["ids"].tobytes() == ranks[0]["ids"].tobytes()
        assert r["scores"].tobytes() == ranks[0]["scores"].tobytes()
    _, test, cate_list = _data(name)
    rec = Recommender.from_model_dir(str(tmp / name), cate_list, device="cpu", k=10,
                                     batch_size=16, exclude_history=exclude)
    requests = _requests(name, test)
    want_ids, want_sc = rec.recommend(requests)
    ids, sc = ranks[0]["ids"], ranks[0]["scores"]
    assert ids.shape == want_ids.shape == (30, 10) and (ids < ITEMS).all()
    np.testing.assert_allclose(sc, want_sc, rtol=TOL, atol=1e-6)
    for row in range(30):
        for j in np.flatnonzero(ids[row] != want_ids[row]):
            tied = np.isclose(want_sc[row], want_sc[row, j], rtol=0, atol=1e-6)
            assert ids[row, j] in set(want_ids[row][tied]) or tied[-1], (row, j)
        if exclude:
            n = requests["sl"][row]
            assert not set(requests["hist_i"][row][K_LSPM - n:]) & set(ids[row])
