"""The decoupled appearance branch of the port's multi-rank step (the bands
gathered, the CNN run on every rank, its L1 term counted once) against the
JAX package's ``make_sharded_train_step`` at world 2 and the port's own
single-rank step, from the same carried appearance network
(tests/test_sharding.py:213-254: loss abs 1e-5, xyz and the appearance
parameters after the step atol 1e-5).
"""

import jax
import numpy as np
import torch

from radegs_tpu.train import loop as jloop
from radegs_torch.models import appearance as ta
from radegs_torch.parallel import run_ranks
from radegs_torch.train.loop import map_app
from test_torch_parallel_ranks import rank_step
from test_torch_parallel_step import CAM, CFG, j_sharded, scene_arrays, t_single

torch.set_num_threads(1)
CFG_APP = ({**CFG[0], "use_decoupled_appearance": True}, CFG[1], CFG[2])


def test_sharded_step_with_appearance():
    js, jc, gt, arrays = scene_arrays()
    m_j, ts_j = j_sharded(js, jc, gt, 2, CFG_APP, app=True)
    p0 = jloop.init_train_state(js, jax.random.PRNGKey(0), 32, 32, True).app_params
    host = jax.tree_util.tree_map(np.asarray, p0)
    params = ta.appearance_from_arrays(host["net"], host["embeddings"], device="cpu")
    app = {"app_params": params, "app_m": map_app(torch.zeros_like, params),
           "app_v": map_app(torch.zeros_like, params)}
    m_1, ts_1 = t_single(arrays, gt, CFG_APP, app)
    outs = run_ranks(rank_step, 2, "gloo", "cpu", timeout_s=240,
                     args=(arrays, CAM, gt, CFG_APP, app))
    (m, fields, app_out), = outs[0].result
    assert outs[1].result[0][2].keys() == app_out.keys()
    for k in app_out:  # replicated: every rank holds the same parameters
        assert np.array_equal(outs[1].result[0][2][k], app_out[k]), k
    jh = jax.tree_util.tree_map(np.asarray, ts_j.app_params)
    want_j = ta.appearance_from_arrays(jh["net"], jh["embeddings"], device="cpu")
    for ref, label in ((m_j, "JAX"), (m_1, "single rank")):
        assert abs(m["loss"] - ref["loss"]) < 1e-5, (label, m["loss"], ref["loss"])
    for xyz, label in ((ts_j.gaussians.params.xyz, "JAX"), (ts_1.gaussians.params.xyz, "single")):
        np.testing.assert_allclose(fields["xyz"], np.asarray(xyz), rtol=0, atol=1e-5,
                                   err_msg=label)
    for want, label in ((want_j, "JAX"), (ts_1.app_params, "single rank")):
        pairs = [(k, v) for k, v in want["net"].items()] + [("embeddings", want["embeddings"])]
        for k, v in pairs:
            np.testing.assert_allclose(app_out[k], v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"{label} {k}")
    moved = sum(not np.array_equal(app_out[k], params["net"][k].numpy())
                for k in params["net"])
    assert moved == len(params["net"])
