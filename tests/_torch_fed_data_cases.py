"""The runs and inputs of the pod-mesh tests (``tests/test_torch_fed_data.py``),
shared by the test module, its rank processes (which import no JAX) and
the reference's subprocesses (which import no ``repro_torch``): the
constants of the ``(pods, data, 1)`` mesh and of each run, and every input
made with numpy from a seed."""
import numpy as np

ARCHS = ("yi-6b", "mamba2-130m")
PODS, DATA = 2, 2
WORLD = PODS * DATA
# a pod's global batch of ROWS x SEQ tokens, STEPS steps, a gossip every EVERY
ROWS, SEQ, STEPS, EVERY, LR_R, KEY_SEED = 4, 32, 3, 2, 20.0, 7
BITS = (32, 8)
GOSSIPS = [step for step in range(STEPS) if (step + 1) % EVERY == 0]
# restore-then-continue: CKPT_STEPS steps, the checkpoint at CKPT_AT
CKPT_STEPS, CKPT_AT, CKPT_SEQ = 6, 3, 16
LAUNCH_ARCH = "mamba2-130m"


def batches(vocab, steps=STEPS, rows=ROWS, seq=SEQ):
    """Every pod's tokens of each step, (PODS, rows, seq + 1), drawn in turn
    from ``default_rng(0)`` as ``launch.train pod --fed`` draws them."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=(PODS, rows, seq + 1)) for _ in range(steps)]


def ckpt_batch(vocab, step):
    """The restore-then-continue run's tokens of ``step``: a stream a step,
    so that a run restored at any step draws what the whole run drew."""
    return np.random.default_rng(100 + step).integers(0, vocab, size=(PODS, ROWS, CKPT_SEQ + 1))


def walk_input(tree):
    """The tree of the walk hand-off: a stacked (PODS, ...) float32 leaf of
    N(0, 1) for each leaf of ``tree``, drawn in sorted-path order."""
    rng = np.random.default_rng(5)
    return {path: rng.standard_normal((PODS, *np.shape(leaf))).astype(np.float32)
            for path, leaf in sorted(flatten(tree).items())}


def flatten(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parts, last = key.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = value
    return tree
