"""The paper's own experimental configuration (§III-IV).

The port's copy of ``src/repro/configs/paper_rag.py``: two embedding
regimes (gte-Qwen2-7B-instruct 3584d, text-embedding-3-large 3072d) over a
1M corpus with 2470 queries; Table III/V progressive configs; the §IV.A
sweep grid.

The corpus is synthetic (`repro_torch.rag.make_corpus`).  ``CONFIG`` is
the paper's scale, which the card holds (1M x 3584 float32 is 14.3 GB);
``SMOKE_CONFIG`` is the reduced budget of the CPU runs (dims scaled about
1/3.5, docs 1/10).  Schedules are expressed relative to whichever d_max
is used.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperRAGConfig:
    n_docs: int = 1_000_000
    n_queries: int = 2470
    dim_gte: int = 3584
    dim_openai: int = 3072
    # Table II/IV truncation sweep (powers of two + full)
    trunc_dims: tuple = (16, 32, 64, 128, 256, 512, 1024, 2048)
    # Table III (gte): (d_start, d_max, K) fastest matched-accuracy configs
    table3_configs: tuple = (
        (128, 512, 128),
        (128, 2048, 16),
        (128, 3584, 64),
        (256, 3584, 16),
        (512, 3584, 16),
    )
    # Table V (openai)
    table5_configs: tuple = (
        (128, 256, 128),
        (256, 512, 16),
        (128, 2048, 32),
        (128, 3072, 64),
        (256, 3072, 64),
    )
    # progressive sweep grid (§IV.A)
    sweep_d_start: tuple = (64, 128, 256, 512, 1024, 2048)
    sweep_k0: tuple = (4, 8, 16, 32, 64, 128, 256, 512, 1024)
    sweep_d_max: tuple = (128, 256, 512, 1024, 2048, 3584)


CONFIG = PaperRAGConfig()

# reduced budget (dims scale ~1/3.5, docs 1/10)
SMOKE_CONFIG = PaperRAGConfig(
    n_docs=100_000, n_queries=1000, dim_gte=1024, dim_openai=768,
    trunc_dims=(16, 32, 64, 128, 256, 512),
    table3_configs=((64, 256, 64), (64, 512, 16), (64, 1024, 32),
                    (128, 1024, 16), (256, 1024, 16)),
    table5_configs=((64, 128, 64), (128, 256, 16), (64, 512, 32),
                    (64, 768, 32), (128, 768, 32)),
    sweep_d_start=(32, 64, 128, 256),
    sweep_k0=(4, 8, 16, 32, 64, 128),
    sweep_d_max=(128, 256, 512, 1024),
)
