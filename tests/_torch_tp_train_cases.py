"""The cases of the tensor-parallel training tests
(``tests/test_torch_tp_train.py``), shared by the test module and its rank
processes, which import no JAX: every model-axis case of
``_torch_tp_cases`` trained at (data 1, model 2), three of them also at
(2, 2), on the data-axis tests' global batches (``_torch_dp_cases``), made
with numpy from a seed."""
from _torch_dp_cases import LR_R, STEPS, batches, flatten, smoke, unflatten  # noqa: F401
from _torch_tp_cases import CASES  # noqa: F401

SHAPE = (4, 12)                      # (B, S) of the global batch
MESH4_CASES = ("yi", "grok-moe", "seamless")
# The two-rank toy of the adjoints: x (B, D) whole, W (D, N) split on its
# columns, A (N, D) on its rows, c (B, D) whole.
TOY_B, TOY_D, TOY_N = 3, 8, 6


def whole_over_model(tree, specs, axis):
    """A tree of model blocks (whole along the data axis) gathered whole:
    each leaf that ``specs`` splits on the model axis, along that dim."""
    if isinstance(tree, dict):
        return {k: whole_over_model(v, specs[k], axis) for k, v in tree.items()}
    return axis.all_gather(tree, specs.index("model")) if "model" in specs else tree
