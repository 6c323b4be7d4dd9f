"""Terminal UI (replaces src/ui/interface.py + main.py)."""

from mediquery_rag.cli.context import AppContext  # noqa: F401
