"""The port's notebook helper and classifier diagnostics
(``utils/notebook.py``, ``utils/diagnostics.py``) against the JAX
package's, on one set of weights carried across by the bridge: the
per-class weight norms and ranked weights equal JAX's bit for bit, and
the plot is written."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cl_object_detection_tpu.utils import diagnostics as jdiag
from cl_object_detection_tpu.utils.notebook import text_to_args as j_text_to_args
from cl_object_detection_tpu_torch.utils import diagnostics as tdiag
from cl_object_detection_tpu_torch.utils.notebook import text_to_args

from test_torch_model import jax_variables, port_model


@pytest.fixture(scope="module")
def weights():
    jmodel, v = jax_variables(seed=3)
    return v, port_model(v).state_dict()


def test_weight_norms_and_ranked_weights_match_jax(weights):
    v, state = weights
    params = jax.tree.map(jnp.asarray, v["params"])
    norms = tdiag.classifier_weight_norms(state)
    assert norms.shape == (3,)
    np.testing.assert_array_equal(norms, np.asarray(jdiag.classifier_weight_norms(params)))
    np.testing.assert_array_equal(tdiag.ranked_mean_weights(state),
                                  np.asarray(jdiag.ranked_mean_weights(params)))


def test_plot_classifier_diagnostics_writes_the_figure(weights, tmp_path):
    pytest.importorskip("matplotlib")
    _, state = weights
    out = str(tmp_path / "diag.png")
    tdiag.plot_classifier_diagnostics(state, ["x", "y", "z"], 2, out)
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("text", ["--scenario 15 1 \n --distill true",
                                  "--root_dir 'a b' --cpu", ""])
def test_text_to_args_matches_jax(text):
    assert text_to_args(text) == j_text_to_args(text)
