"""musicgen-large [audio] -- 48L d_model=2048 32H (GQA kv=32, i.e. MHA)
d_ff=8192 vocab=2048, decoder-only over EnCodec tokens.  [arXiv:2306.05284]

The mel-spectrogram/EnCodec conv frontend is a STUB: ``input_specs``
provides 256 precomputed conditioning frame embeddings; the decoder
autoregresses over the 2048-entry EnCodec codebook vocabulary.
"""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048,
    act="gelu",
    frontend="audio", n_frontend_tokens=256,
    source="arXiv:2306.05284",
)

SMOKE = ArchConfig(
    name="musicgen-large-smoke", family="audio",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab=256,
    act="gelu",
    frontend="audio", n_frontend_tokens=16,
    source="reduced variant of musicgen-large",
)
