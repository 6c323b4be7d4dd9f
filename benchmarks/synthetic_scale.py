"""Synthetic-scale demonstration for the two data-hungry model families.

VERDICT r4 weak item 7: the cross-encoder grader (held-out AUC 0.53) and
the from-scratch contrastive encoder (held-out r@1 0.50) both memorize at
the shipping 160-chunk corpus, and the defaults route around them — "either
demonstrate them at a scale where they win (synthetic corpus is fine) or
mark them experimental". Both carry the experimental marking; this
benchmark delivers the demonstration half: the SAME architectures and the
SAME training entry points (models/cross_encoder.py:train_cross_encoder,
models/trainer.py:ContrastiveTrainer), trained on a generated corpus big
enough to generalize, with the 160-pair failure reproduced in-session as
the A/B.

The synthetic task mirrors the real one (reference ingest_medical.py's
title->content pairs): each "disease" entity gets a templated Chinese
document (symptoms / cause / treatment drawn from shared pools) and
paraphrase queries that mention the entity by name. Entity names are
random CJK strings, train/held-out DISJOINT — so held-out success requires
the relational skill the 160-pair run failed to learn (match the query's
entity mention against the document, through a hash-char vocabulary),
not recall of any training row.

    python benchmarks/synthetic_scale.py                  # full demo (CPU)
    python benchmarks/synthetic_scale.py --entities 400   # quick smoke
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# Shared attribute pools (synthetic; every doc/query is assembled from
# these plus a random entity name — nothing comes from the eval corpus).
SYMPTOMS = [
    "头晕", "乏力", "胸闷", "心悸", "咳嗽", "发热", "盗汗", "消瘦",
    "腹胀", "腹泻", "便秘", "恶心", "呕吐", "食欲不振", "口干", "口苦",
    "失眠", "多梦", "健忘", "耳鸣", "视物模糊", "手脚发麻", "关节疼痛",
    "腰酸背痛", "皮肤瘙痒", "皮疹", "水肿", "尿频", "尿急", "气短",
    "咽喉肿痛", "鼻塞", "流涕", "畏寒", "出冷汗", "面色苍白", "心慌",
    "胃痛", "反酸", "打嗝",
]
CAUSES = [
    "长期熬夜", "饮食不规律", "精神压力过大", "缺乏运动", "遗传因素",
    "病毒感染", "细菌感染", "免疫力下降", "内分泌失调", "气血不足",
    "受凉", "过度劳累", "营养不良", "环境刺激", "药物副作用", "吸烟饮酒",
]
TREATMENTS = [
    "规律作息", "清淡饮食", "适量运动", "药物治疗", "物理治疗",
    "心理疏导", "补充维生素", "中药调理", "针灸推拿", "手术治疗",
    "定期复查", "多喝温水", "热敷理疗", "戒烟限酒", "控制体重",
    "抗感染治疗", "对症止痛", "雾化吸入", "输液治疗", "康复训练",
]
QUERY_TEMPLATES = [
    "得了{e}一般有什么表现",
    "{e}应该怎么治疗比较好",
    "{e}是什么原因引起的",
    "怀疑自己有{e}该怎么办",
    "{e}平时要注意些什么",
]
# entity names: random CJK chars from a fixed block, so held-out names are
# novel char combinations the tokenizer hashes like any other text
_CJK = [chr(c) for c in range(0x4E00, 0x4E00 + 2048)]


def gen_entity(rng: np.random.Generator) -> tuple[str, str]:
    """(name, document) for one synthetic disease."""
    name = "".join(rng.choice(_CJK) for _ in range(int(rng.integers(2, 4))))
    s = rng.choice(len(SYMPTOMS), size=3, replace=False)
    t = rng.choice(len(TREATMENTS), size=2, replace=False)
    c = CAUSES[int(rng.integers(len(CAUSES)))]
    doc = (f"{name}的典型症状包括{SYMPTOMS[s[0]]}、{SYMPTOMS[s[1]]}和"
           f"{SYMPTOMS[s[2]]}。常见诱因是{c}。"
           f"建议治疗方式为{TREATMENTS[t[0]]}和{TREATMENTS[t[1]]}。")
    return name, doc


def gen_pairs(n: int, rng: np.random.Generator, seen: set | None = None):
    """n entities -> (queries, docs); one paraphrase query per entity.
    Pass the same ``seen`` set across calls to guarantee disjoint names."""
    qs, ds = [], []
    seen = set() if seen is None else seen
    while len(ds) < n:
        name, doc = gen_entity(rng)
        if name in seen:
            continue
        seen.add(name)
        tmpl = QUERY_TEMPLATES[int(rng.integers(len(QUERY_TEMPLATES)))]
        qs.append(tmpl.format(e=name))
        ds.append(doc)
    return qs, ds


def auc(pos: np.ndarray, neg: np.ndarray) -> float:
    return float((pos[:, None] > neg[None, :]).mean()
                 + 0.5 * (pos[:, None] == neg[None, :]).mean())


def eval_cross_encoder(params, cfg, qs, ds, rng) -> dict:
    from mediquery_rag.models.cross_encoder import score_pairs
    neg_ds = [ds[(i + 1 + int(rng.integers(len(ds) - 1))) % len(ds)]
              for i in range(len(ds))]
    pos = score_pairs(params, cfg, qs, ds)
    neg = score_pairs(params, cfg, qs, neg_ds)
    return {"auc": round(auc(pos, neg), 4),
            "acc@0": round(0.5 * float((pos > 0).mean())
                           + 0.5 * float((neg <= 0).mean()), 4)}


def run_cross_encoder(n_train: int, n_held: int, epochs: int,
                      batch: int, lr: float, seed: int) -> dict:
    from mediquery_rag.config import EmbedderConfig
    from mediquery_rag.models.cross_encoder import train_cross_encoder

    rng = np.random.default_rng(seed)
    seen: set = set()
    tq, td = gen_pairs(n_train, rng, seen)
    hq, hd = gen_pairs(n_held, rng, seen)   # shared ``seen``: disjoint names
    cfg = EmbedderConfig(vocab_size=2048, hidden=128, layers=2, heads=4,
                         mlp_dim=256, max_len=160, dtype="bfloat16")
    t0 = time.time()
    params, _, loss = train_cross_encoder(
        list(zip(tq, td)), cfg, epochs=epochs, batch_size=batch, lr=lr,
        seed=seed)
    out = {"n_train_pairs": n_train, "epochs": epochs,
           "train_s": round(time.time() - t0, 1),
           "final_loss": round(loss, 4),
           "heldout": eval_cross_encoder(params, cfg, hq, hd, rng)}
    return out


def run_bi_encoder(n_train: int, n_held: int, epochs: int,
                   batch: int, lr: float, seed: int) -> dict:
    import jax

    from mediquery_rag.config import EmbedderConfig, TrainConfig
    from mediquery_rag.models import HashCharTokenizer, TextEmbedder
    from mediquery_rag.models.data import TripletLoader
    from mediquery_rag.models.eval import retrieval_recall
    from mediquery_rag.models.trainer import ContrastiveTrainer

    rng = np.random.default_rng(seed + 1)
    seen: set = set()
    tq, td = gen_pairs(n_train, rng, seen)
    hq, hd = gen_pairs(n_held, rng, seen)
    mcfg = EmbedderConfig(vocab_size=2048, hidden=128, layers=2, heads=4,
                          mlp_dim=256, max_len=128, dtype="bfloat16")
    tcfg = TrainConfig(batch_size=batch, lr=lr, warmup_steps=20)
    examples = [(q, d, i) for i, (q, d) in enumerate(zip(tq, td))]
    negatives = [td[(i + 1 + int(rng.integers(len(td) - 1))) % len(td)]
                 for i in range(len(td))]
    tok = HashCharTokenizer(mcfg.vocab_size, mcfg.max_len)
    loader = TripletLoader(examples, negatives, tok, batch,
                           seed=seed, augment=False, max_len=mcfg.max_len)
    trainer = ContrastiveTrainer(mcfg, tcfg)
    state = trainer.init_state(jax.random.PRNGKey(seed))
    t0 = time.time()
    steps = 0
    for b in loader.batches(epochs=epochs):
        state, metrics = trainer.train_step(state, b)
        steps += 1
    te = TextEmbedder(mcfg, params=jax.device_get(state.params))
    doc_ids = [str(i) for i in range(len(hd))]
    rec = retrieval_recall(te.embed, hd, doc_ids, hq, doc_ids)
    return {"n_train_pairs": n_train, "epochs": epochs, "steps": steps,
            "train_s": round(time.time() - t0, 1),
            "final_loss": round(float(metrics["loss"]), 4),
            "heldout": {k: round(v, 4) for k, v in rec.items()}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entities", type=int, default=4000,
                    help="training entities at the 'scale' point")
    ap.add_argument("--heldout", type=int, default=300)
    ap.add_argument("--small", type=int, default=160,
                    help="the corpus-scale A/B point (0 disables)")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--small-epochs", type=int, default=40,
                    help="epochs at the small point (match grader_eval)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-bi", action="store_true")
    ap.add_argument("--skip-ce", action="store_true")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")   # deterministic

    report: dict = {}
    if not args.skip_ce:
        if args.small:
            report["cross_encoder_small"] = run_cross_encoder(
                args.small, args.heldout, args.small_epochs, args.batch,
                args.lr, args.seed)
            print(json.dumps({"cross_encoder_small":
                              report["cross_encoder_small"]}))
        report["cross_encoder_scale"] = run_cross_encoder(
            args.entities, args.heldout, args.epochs, args.batch,
            args.lr, args.seed)
        print(json.dumps({"cross_encoder_scale":
                          report["cross_encoder_scale"]}))
    if not args.skip_bi:
        if args.small:
            report["bi_encoder_small"] = run_bi_encoder(
                args.small, args.heldout, args.small_epochs, args.batch,
                args.lr, args.seed)
            print(json.dumps({"bi_encoder_small":
                              report["bi_encoder_small"]}))
        report["bi_encoder_scale"] = run_bi_encoder(
            args.entities, args.heldout, args.epochs, args.batch,
            args.lr, args.seed)
        print(json.dumps({"bi_encoder_scale":
                          report["bi_encoder_scale"]}))
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
