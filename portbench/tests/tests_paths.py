from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
CONFIGS = BENCH / "configs"
