from hirest_tpu_torch.tokenizers.bpe import ClipBPETokenizer, clip_tokenize  # noqa: F401
from hirest_tpu_torch.tokenizers.wordpiece import WordPieceTokenizer  # noqa: F401
