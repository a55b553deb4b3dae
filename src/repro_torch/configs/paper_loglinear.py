"""The paper's own setting (counterpart of
``repro/configs/paper_loglinear.py``): a log-linear model over a fixed
feature table — ImageNet style, n ≈ 1.28M ResNet features of d 256; word
embedding style, n ≈ 2M fastText vectors of d 300 — queried with a stream
of parameter vectors θ. There is no trunk: the model is the head. Used
directly through :mod:`repro_torch.core`; the architecture registry does
not list it, as the reference's does not."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LogLinearConfig:
    name: str
    n: int  # output-space size
    d: int  # feature dim
    temperature: float = 0.05  # paper §4.1.2
    mips: str = "ivf"
    delta: float = 1e-4


IMAGENET = LogLinearConfig(name="imagenet", n=1_281_167, d=256)
WORD_EMBEDDINGS = LogLinearConfig(name="word-embeddings", n=2_000_126, d=300)

# the same families at 160,000 rows, the reference's benchmark sizes
IMAGENET_BENCH = LogLinearConfig(name="imagenet-bench", n=160_000, d=256)
WORDS_BENCH = LogLinearConfig(name="words-bench", n=160_000, d=300)

CONFIG = IMAGENET
