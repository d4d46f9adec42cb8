"""A minimal static HTML image gallery, the port of vid2vid_tpu/utils/html.py
(reference: util/html.py, without its dominate dependency)."""

from __future__ import annotations

import html
import os


class HTMLGallery:
    def __init__(self, web_dir: str, title: str):
        self.web_dir = web_dir
        self.title = title
        self.body: list[str] = []
        os.makedirs(web_dir, exist_ok=True)

    def add_header(self, text: str):
        self.body.append(f"<h3>{html.escape(text)}</h3>")

    def add_images(self, ims: list[str], txts: list[str], width: int = 400):
        cells = []
        for im, txt in zip(ims, txts):
            cells.append(
                "<td style='text-align:center'>"
                f"<a href='{im}'><img src='{im}' style='width:{width}px'></a>"
                f"<br><p>{html.escape(txt)}</p></td>"
            )
        self.body.append(
            "<table style='border-collapse:collapse'><tr>" + "".join(cells) + "</tr></table>"
        )

    def save(self, filename: str = "index.html"):
        doc = (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(self.title)}</title></head><body>"
            f"<h1>{html.escape(self.title)}</h1>"
            + "".join(self.body)
            + "</body></html>"
        )
        with open(os.path.join(self.web_dir, filename), "w") as fh:
            fh.write(doc)
