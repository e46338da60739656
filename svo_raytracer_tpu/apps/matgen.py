"""Material-map baking CLI — the MaterialTextureGenerator analog.

Merges per-material mask PNGs into a single material-index PNG plus an
x16-scaled visualization (``src/tests/MaterialTextureGenerator.java:26-64``):
wherever a material's mask pixel is "on" (the reference tests for 16-bit -1,
i.e. saturated), the combined map takes that material's id.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core import materials
from ..io.image import encode_png, read_png, write_png


def bake(size: int = 8192, asset_dir: str = "./assets",
         out_path: str | None = None):
    materials.init_materials(asset_dir)
    combined = np.zeros((size, size), np.uint8)
    for mid in range(materials.get_num_mats()):
        mat = materials.get_material(mid)
        if mat is None or not mat.has_matmap():
            continue
        try:
            mask = read_png(mat.matmap_file_path)
        except FileNotFoundError:
            print(f"# missing mask for {mat.name}: {mat.matmap_file_path}",
                  file=sys.stderr)
            continue
        if mask.ndim == 3:
            mask = mask[..., 0]
        # saturated mask pixels select this material
        # (MaterialTextureGenerator.java:47-55 tests for == -1 on int16)
        sat = mask == np.iinfo(mask.dtype).max
        combined[sat[:size, :size]] = mat.value
    if out_path is None:
        out_path = f"{asset_dir}/matmaps/nz/materials.png"
    with open(out_path, "wb") as f:
        f.write(encode_png(combined))
    vis = (combined.astype(np.float32) * 16 / 255.0)
    write_png(out_path.replace(".png", "_vis.png"),
              np.repeat(vis[:, :, None], 3, axis=2), flip=False)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, default=8192)
    ap.add_argument("--assets", default="./assets")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = bake(args.size, args.assets, args.out)
    print(f"wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
