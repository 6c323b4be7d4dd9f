"""Application wiring: build every component once, inject everywhere.

Replaces the reference's module-level singleton init (medical_engine.py:43-60
+ main.py:29-51) with an explicit, testable context object. Key behavioral
upgrade: no hard exit when a dependency is missing (the reference dies if
./medical_db is absent, medical_engine.py:34-37) — the context degrades:
missing index → build it from the corpus; no LLM server → FakeLLM notice;
no web key → web search disabled.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

from mediquery_rag.config import Config, load as load_config
from mediquery_rag.graph import build_medical_graph, create_nodes
from mediquery_rag.graph.engine import SqliteCheckpointer
from mediquery_rag.app.memory import (
    HITLManager, ProfileStore, UserProfileMarkdown,
    extract_health_info, load_health_profile,
)
from mediquery_rag.ingest import DocumentStore, build_document_store
from mediquery_rag.llm import FakeLLM, HTTPChatClient


@dataclass
class AppContext:
    cfg: Config
    llm: object
    embedder: Callable
    store: DocumentStore
    profile_store: ProfileStore
    hitl: HITLManager
    graph_app: object
    web_search: Callable | None = None

    @staticmethod
    def _lexical_embedder(root: str, cfg: Config):
        """The lexical retrieval channel: a corpus-fitted IDF n-gram
        embedder (models/lexical.py), persisted to checkpoints/ so
        reloads keep the embedder fingerprint (and therefore the saved
        index) stable. Falls back to the dependency-free flat hasher only
        when there is no corpus to fit on."""
        from mediquery_rag.models import IDFHashingEmbedder
        state = os.path.join(root, "checkpoints", "lexical_idf.json")
        if os.path.exists(state):
            try:
                return IDFHashingEmbedder.load(state)
            except (ValueError, KeyError, OSError) as e:
                print(f"（词面 IDF 状态损坏，重新拟合：{e}）")
        if os.path.exists(cfg.paths.corpus_file):
            from mediquery_rag.ingest.parser import parse_corpus_file
            emb = IDFHashingEmbedder.fit_chunks(
                parse_corpus_file(cfg.paths.corpus_file))
            try:
                emb.save(state)
            except OSError:
                pass
            return emb
        from mediquery_rag.models import HashingEmbedder
        return HashingEmbedder(cfg.embedder.hidden)

    @classmethod
    def build(
        cls,
        root: str = ".",
        *,
        fake_llm: bool = False,
        use_trained_encoder: bool | None = None,
        llm_url: str = "http://localhost:11434",
        llm: object | None = None,
        web_search: Callable | None = None,
        index_kind: str | None = None,
    ) -> "AppContext":
        cfg = load_config(root)
        index_kind = (index_kind
                      or os.environ.get("MEDIQUERY_INDEX", "")
                      or cfg.engine.index_kind)
        if index_kind not in ("flat", "ivf"):
            raise ValueError(f"unknown index_kind {index_kind!r}")

        # embedder selection: a pretrained HF zh encoder (dmeta-class BERT,
        # MEDIQUERY_HF_EMBEDDER=<dir>) beats everything > the corpus-fitted
        # IDF lexical embedder — the measured-best zero-egress default
        # (held-out recall@1 0.857 / recall@5 1.0 / recall@10 1.0; every
        # hybrid fusion with the from-scratch encoder scores lower because
        # the encoder memorizes at 160-chunk scale — train recall@1 0.994
        # vs held-out 0.50, benchmarks/retrieval_eval.py). The hybrid
        # fusion stays available behind MEDIQUERY_HYBRID=1 (+ trained
        # checkpoint) for corpora large enough to train on; flat hashing
        # only if there is no corpus to fit IDF on.
        hf_emb = os.environ.get("MEDIQUERY_HF_EMBEDDER", "")
        ckpt = os.path.join(root, "checkpoints", "embedder")
        if use_trained_encoder is None:
            use_trained_encoder = os.path.exists(
                os.path.join(ckpt, "params.npz"))
        want_hybrid = os.environ.get("MEDIQUERY_HYBRID", "") == "1"
        lexical = cls._lexical_embedder(root, cfg)
        if hf_emb and os.path.isdir(hf_emb):
            from mediquery_rag.models import BertTextEmbedder
            embedder = BertTextEmbedder.from_hf(hf_emb)
            print("  预训练 HF 嵌入模型已加载（设备推理）")
        elif want_hybrid and use_trained_encoder and os.path.exists(
                os.path.join(ckpt, "config.json")):
            from mediquery_rag.models import HybridEmbedder
            embedder = HybridEmbedder.from_checkpoint(
                ckpt, lex_dim=cfg.embedder.hidden, lexical=lexical,
                w_lex=0.9)
            print("  混合嵌入已启用（IDF 词面通道 + 训练编码器，设备推理）")
        else:
            embedder = lexical

        # document store: load checkpoint or (re)build from corpus; a saved
        # index whose chunk ids no longer match the corpus file (content
        # added/removed since the save) is stale and rebuilt
        idx = cfg.paths.index_dir
        store = None
        if os.path.exists(os.path.join(idx, "chunks.jsonl")):
            try:
                store = DocumentStore.load(idx, embedder)
                from mediquery_rag.engine import IVFIndex
                loaded_kind = ("ivf" if isinstance(store.index, IVFIndex)
                               else "flat")
                if loaded_kind != index_kind:
                    print(f"（索引类型已切换：{loaded_kind} -> "
                          f"{index_kind}，重新构建）")
                    store = None
                if store is not None and os.path.exists(
                        cfg.paths.corpus_file):
                    from mediquery_rag.ingest.parser import (
                        parse_corpus_file)
                    want = {c.chunk_id
                            for c in parse_corpus_file(cfg.paths.corpus_file)}
                    have = {c.chunk_id for c in store.chunks if c is not None}
                    if want != have:
                        print(f"（语料已更新：{len(have)} -> {len(want)} "
                              "条，重新构建索引）")
                        store = None
            except ValueError as e:       # embedder fingerprint mismatch
                print(f"（索引与当前嵌入模型不匹配，重新构建：{e}）")
        if store is None:
            store = build_document_store(cfg.paths.corpus_file, embedder,
                                         cfg.engine, kind=index_kind)
            try:
                store.save(idx)
            except OSError:
                pass

        # LLM selection: an explicit client > scripted fake > pretrained HF
        # qwen2-class checkpoint (MEDIQUERY_HF_LLM=<dir>, served on the
        # device with int8 weight-only quantization) > on-device decoder
        # checkpoint (models/train_lm writes one) > HTTP client to a local
        # server — the on-device decoder removes the reference's hard
        # dependency on an out-of-process Ollama daemon
        # (medical_engine.py:46). A checkpoint that fails to load raises.
        hf_llm = os.environ.get("MEDIQUERY_HF_LLM", "")
        lm_ckpt = os.path.join(root, "checkpoints", "lm")
        if llm is not None:
            pass
        elif fake_llm:
            llm = FakeLLM(default=(
                "（演示模式：未连接本地 LLM 服务，回答为占位内容。"
                "启动兼容 OpenAI 接口的本地服务后去掉 --fake-llm 即可。）"
            ))
        elif hf_llm and os.path.isdir(hf_llm):
            from mediquery_rag.llm import DeviceLLMClient
            # MEDIQUERY_HF_LLM_QUANT: "8" (default) int8, "4" int4 (the
            # tier Ollama's default GGUF serves the reference at), "0" off
            qflag = os.environ.get("MEDIQUERY_HF_LLM_QUANT", "8")
            # MEDIQUERY_HF_LLM_KV=int8: quantized KV cache (half the
            # serving-cache HBM; see DecoderConfig.kv_dtype)
            llm = DeviceLLMClient.from_hf(
                hf_llm, quantize=0 if qflag == "0" else
                (4 if qflag == "4" else 8),
                kv_dtype=os.environ.get("MEDIQUERY_HF_LLM_KV", ""))
            print("  预训练 HF 语言模型已加载（设备推理，无需外部服务）")
        elif os.path.exists(os.path.join(lm_ckpt, "params.npz")):
            from mediquery_rag.llm import DeviceLLMClient
            llm = DeviceLLMClient.from_checkpoint(lm_ckpt)
            print("  本地语言模型已加载（设备推理，无需外部 LLM 服务）")
        else:
            llm = HTTPChatClient(llm_url)

        # web search: explicit tool > Tavily-by-env-key > disabled
        if web_search is None:
            from mediquery_rag.llm.web import TavilyClient
            tavily = TavilyClient(max_results=cfg.graph.web_results)
            web_search = tavily if tavily.available else None

        os.makedirs(cfg.paths.user_data_dir, exist_ok=True)
        profile_store = ProfileStore(
            cfg.paths.profile_db,
            markdown_sync=UserProfileMarkdown(
                os.path.join(cfg.paths.user_data_dir, "profiles_md")),
        )
        hitl = HITLManager(cfg.paths.review_dir, profile_store)

        # a trained cross-encoder grader replaces the per-loop LLM
        # document grading when its checkpoint exists (models/train_grader)
        grade_fn = None
        grader_dir = os.path.join(root, "checkpoints", "grader")
        if os.path.exists(os.path.join(grader_dir, "params.npz")):
            from mediquery_rag.models.cross_encoder import TrainedGrader
            try:
                grade_fn = TrainedGrader.from_checkpoint(grader_dir)
                print("  交叉编码器文档评分器已加载（替代 LLM grade）")
            except Exception as e:     # stale/mismatched checkpoint must
                grade_fn = None        # fall back, never abort startup
                print(f"  ⚠️ 评分器加载失败，回退 LLM grade：{e}")
        if grade_fn is None:
            from mediquery_rag.models import HashingEmbedder
            if not isinstance(embedder, HashingEmbedder):
                # semantic embedder present: bi-encoder similarity grade is
                # the measured-best default at small training scale
                # (benchmarks/grader_eval.py: AUC 0.93 vs cross-encoder 0.52)
                from mediquery_rag.models import (
                    HybridEmbedder, IDFHashingEmbedder)
                from mediquery_rag.models.cross_encoder import (
                    SimilarityGrader)
                # per-embedder thresholds, measured on held-out
                # (query, gold) vs (query, random) cosines: IDF lexical
                # pairs peak low (pos mean .29, neg mean .03 → best
                # balanced acc .95 @ 0.1), hybrid at 0.2, pure semantic
                # at 0.3 (benchmarks/grader_eval.py)
                if isinstance(embedder, IDFHashingEmbedder):
                    thr = 0.1
                elif isinstance(embedder, HybridEmbedder):
                    thr = 0.2
                else:
                    thr = 0.3
                grade_fn = SimilarityGrader(embedder, threshold=thr)
                print("  嵌入相似度评分器已启用（替代 LLM grade）")

        checkpointer = SqliteCheckpointer(cfg.paths.chat_db)
        nodes = create_nodes(
            llm, store,
            web_search=web_search,
            extract_health=lambda q, uid: extract_health_info(
                q, uid, llm, profile_store, hitl=hitl),
            load_profile=lambda uid: load_health_profile(uid, profile_store),
            cfg=cfg.graph,
            top_k=cfg.engine.top_k,
            grade_fn=grade_fn,
        )
        graph_app = build_medical_graph(nodes, checkpointer)
        return cls(cfg, llm, embedder, store, profile_store, hitl,
                   graph_app, web_search)
