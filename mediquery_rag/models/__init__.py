"""On-device embedding models.

Replaces the reference's out-of-process embedding inference
(``OllamaEmbeddings(model="shaw/dmeta-embedding-zh")`` over HTTP to a GGML
C++ daemon — reference medical_engine.py:43, ingest_medical.py:104) with an
in-process JAX forward pass on the device: a 768-d BERT-style encoder (the same
architecture class as dmeta-embedding-zh), jit/pjit-compiled, batched.

Also provides a deterministic hash-feature embedder so the full RAG stack
runs (and is tested) without trained weights or network access.
"""

from mediquery_rag.models.tokenizer import HashCharTokenizer  # noqa: F401
from mediquery_rag.models.embedder import Embedder, EmbedderParams  # noqa: F401
from mediquery_rag.models.hash_embedder import HashingEmbedder  # noqa: F401
from mediquery_rag.models.lexical import IDFHashingEmbedder  # noqa: F401
from mediquery_rag.models.lexicon import (  # noqa: F401
    ZH_MEDICAL_SYNONYMS, expand_query,
)
from mediquery_rag.models.hybrid_embedder import HybridEmbedder  # noqa: F401
from mediquery_rag.models.text_embedder import TextEmbedder  # noqa: F401
from mediquery_rag.models.cross_encoder import (  # noqa: F401
    CrossEncoder, make_grader, train_cross_encoder,
)
from mediquery_rag.models.byte_tokenizer import ByteTokenizer  # noqa: F401
from mediquery_rag.models.bpe_tokenizer import BPETokenizer  # noqa: F401
from mediquery_rag.models.decoder import Decoder, KVCache  # noqa: F401
from mediquery_rag.models.generate import Generator  # noqa: F401
from mediquery_rag.models.bert_encoder import BertEncoder  # noqa: F401
from mediquery_rag.models.wordpiece_tokenizer import (  # noqa: F401
    WordPieceTokenizer,
)
from mediquery_rag.models.hf_import import (  # noqa: F401
    BertTextEmbedder, load_bert, load_qwen2, load_qwen2_generator,
    read_safetensors,
)
from mediquery_rag.models.lora import (  # noqa: F401
    LoraTrainer, load_adapters, lora_init, lora_merge, save_adapters,
)
