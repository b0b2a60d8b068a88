"""The card's published peaks (`peaks.json`)."""
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
