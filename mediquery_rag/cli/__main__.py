"""Entry point: ``python -m mediquery_rag.cli`` (replaces main.py)."""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(description="MediQuery CLI")
    ap.add_argument("--fake-llm", action="store_true",
                    help="run without a local LLM server (placeholder answers)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend, without the trained encoder")
    ap.add_argument("--root", default=".", help="data root directory")
    ap.add_argument("--llm-url", default="http://localhost:11434")
    ap.add_argument("--index", choices=("flat", "ivf"), default=None,
                    help="index type (default: config/engine.index_kind)")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from mediquery_rag import compile_cache
    compile_cache.enable()

    from mediquery_rag.cli.context import AppContext
    from mediquery_rag.cli.interface import main_menu

    print("初始化引擎（首次编译可能需要 20-40 秒）…")
    ctx = AppContext.build(
        args.root,
        fake_llm=args.fake_llm,
        use_trained_encoder=False if args.cpu else None,
        llm_url=args.llm_url,
        index_kind=args.index,
    )
    print(f"就绪：{len(ctx.store.chunks)} 条知识库条目。")
    main_menu(ctx)


if __name__ == "__main__":
    main()
