"""Generate a static HTML gallery for eyeballing images or overlays.

Counterpart of ``diagnosis/generate_html_page.py`` / ``hicodet/utilities/
generate_html_page.py``: emits a paginated grid of <img> tags for a directory
of images.

    python -m skghoi_torch.tools.generate_html_page IMAGE_DIR --output gallery.html

Mirrors ``skghoi_tpu.tools.generate_html_page``; host only.
"""

from __future__ import annotations

import argparse
import os

PAGE = """<!DOCTYPE html>
<html><head><title>{title}</title>
<style>img {{ width: 320px; margin: 4px; }} figure {{ display: inline-block; }}</style>
</head><body><h1>{title}</h1>
{body}
</body></html>
"""


def main(argv=None):
    p = argparse.ArgumentParser(description="HTML gallery generator")
    p.add_argument("image_dir")
    p.add_argument("--output", default="gallery.html")
    p.add_argument("--per-page", default=100, type=int)
    p.add_argument("--title", default="skghoi gallery")
    args = p.parse_args(argv)

    images = sorted(
        f for f in os.listdir(args.image_dir) if f.lower().endswith((".jpg", ".png", ".jpeg"))
    )
    pages = [images[i : i + args.per_page] for i in range(0, len(images), args.per_page)]
    base, ext = os.path.splitext(args.output)
    for pi, page in enumerate(pages):
        body = "\n".join(
            f'<figure><img src="{os.path.join(args.image_dir, f)}"/>'
            f"<figcaption>{f}</figcaption></figure>"
            for f in page
        )
        nav = " | ".join(
            f'<a href="{base}_{i}{ext}">page {i}</a>' for i in range(len(pages))
        )
        out = f"{base}_{pi}{ext}" if len(pages) > 1 else args.output
        with open(out, "w") as f:
            f.write(PAGE.format(title=args.title, body=nav + "<hr/>" + body))
    print(f"Wrote {len(pages)} page(s) for {len(images)} images")


if __name__ == "__main__":
    main()
