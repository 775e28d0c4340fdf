"""Model configs (port of ``repro.configs``; qwen3-0.6b only in this slice)."""
