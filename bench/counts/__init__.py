"""Operation and byte counts computed from shapes, and the chip's peaks:
the yardstick the rooflines and the utilisation divide by."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
