"""Configuration helpers: the port's own copy of `load_dotenv` from
`medical_image_editing_tpu/utils/config.py`."""

import os


def load_dotenv(path: str = ".env") -> dict:
    """Minimal python-dotenv replacement (the reference loads `.env` for
    checkpoint paths — `run_recon.py:20-24`). Parses KEY=VALUE lines into
    os.environ (existing variables win) and returns the parsed dict."""
    parsed = {}
    if not os.path.exists(path):
        return parsed
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip().strip("'\"")
            parsed[key] = value
            os.environ.setdefault(key, value)
    return parsed
