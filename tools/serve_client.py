"""Send one request to each endpoint of a running server
(`python -m omnimamba_tpu_torch.scripts.serve`) and print status, seconds
and what came back; exit non-zero unless every answer is a 200 of the right
form. Standard library and numpy only (the card's machine has no curl
guarantee and no PIL):

    python3 tools/serve_client.py [--url http://127.0.0.1:8000] [--wait 300]

``--wait`` retries /healthz for that many seconds while the server loads.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from omnimamba_tpu_torch.serve.png import decode_png, encode_png  # noqa: E402


def call(url, obj=None, timeout=300.0):
    req = urllib.request.Request(url, data=None if obj is None else json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--url", default="http://127.0.0.1:8000")
    p.add_argument("--wait", type=float, default=300.0)
    args = p.parse_args()
    deadline = time.time() + args.wait
    while True:
        try:
            health = call(args.url + "/healthz", timeout=10)
            break
        except (urllib.error.URLError, ConnectionError):
            if time.time() > deadline:
                print("no server at", args.url, file=sys.stderr)
                return 1
            time.sleep(2)
    image = np.random.default_rng(0).integers(0, 256, (384, 512, 3), dtype=np.uint8)
    mmu = {"image_png_b64": base64.b64encode(encode_png(image)).decode(),
           "question": "What is in this image?"}
    ok = health[0] == 200 and health[1].get("status") == "ok"
    print(json.dumps({"healthz": health[1], "seconds": health[2]}))
    for name, path, payload in (("t2i", "/v1/t2i", {"prompt": "a red cat on a mat"}),
                                ("mmu", "/v1/mmu", mmu)):
        for attempt in ("first", "second"):
            code, body, secs = call(args.url + path, payload)
            if name == "t2i" and code == 200:
                shape = decode_png(base64.b64decode(body["image_png_b64"])).shape
                good, shown = shape == (256, 256, 3), {"image_shape": list(shape)}
            else:
                good, shown = code == 200 and isinstance(body.get("text"), str), body
            ok = ok and good
            print(json.dumps({name: attempt, "status": code, "seconds": secs, **shown}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
