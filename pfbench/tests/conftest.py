import pytest

# Tiny sizes for the CPU walks: the cells' own shapes, far less scale.
TINY = {
    "fused-pan256.hap8": {"config": {"text_bp": 1 << 15}},
    "vcf-panel.s16": {"config": {"contig_bp": [6000, 3000], "samples": 3}},
}

@pytest.fixture
def card():
    """The first CUDA card; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
