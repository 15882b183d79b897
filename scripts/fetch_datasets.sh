#!/usr/bin/env bash
# Fetch the real eval datasets (BASELINE.json:7-11) into $HNSW_DATA
# (default ./data) and verify exact file sizes (see data/README.md — sizes
# are fully determined by the file formats, so a size match is a complete
# truncation check; cross-check md5 against the publishers' lists).
#
# Requires network egress; the benchmarks fall back to shape-matched
# synthetic workloads without these files. Run this wherever you have
# connectivity.
set -euo pipefail

ROOT="${HNSW_DATA:-data}"
mkdir -p "$ROOT"
cd "$ROOT"

check_size() { # path expected_bytes
  local got
  got=$(stat --format=%s "$1" 2>/dev/null || stat -f%z "$1")
  if [[ "$got" != "$2" ]]; then
    echo "SIZE MISMATCH: $1 has $got bytes, expected $2 (truncated download?)" >&2
    exit 1
  fi
  echo "ok: $1 ($got bytes)"
}

# ---- TEXMEX: siftsmall / sift / gist --------------------------------------
for ds in siftsmall sift gist; do
  if [[ ! -d $ds ]]; then
    curl -fL -O "ftp://ftp.irisa.fr/local/texmex/corpus/${ds}.tar.gz"
    tar xzf "${ds}.tar.gz" && rm "${ds}.tar.gz"
  fi
done
check_size siftsmall/siftsmall_base.fvecs        5160000
check_size siftsmall/siftsmall_query.fvecs       51600
check_size siftsmall/siftsmall_groundtruth.ivecs 40400
check_size sift/sift_base.fvecs                  516000000
check_size sift/sift_query.fvecs                 5160000
check_size sift/sift_groundtruth.ivecs           4040000
check_size gist/gist_base.fvecs                  3844000000
check_size gist/gist_query.fvecs                 3844000
check_size gist/gist_groundtruth.ivecs           404000

# ---- GloVe-100 angular (ann-benchmarks HDF5) ------------------------------
if [[ ! -f glove-100-angular.hdf5 ]]; then
  curl -fL -O "https://ann-benchmarks.com/glove-100-angular.hdf5"
fi
python - <<'EOF'
import h5py
with h5py.File("glove-100-angular.hdf5", "r") as f:
    assert f["train"].shape == (1183514, 100), f["train"].shape
    assert f["test"].shape[1] == 100
print("ok: glove-100-angular.hdf5", dict(train=f["train"].shape))
EOF

# ---- Deep10M (first 10M rows of Deep1B) -----------------------------------
mkdir -p deep
if [[ ! -f deep/query.public.10K.fbin ]]; then
  curl -fL -o deep/query.public.10K.fbin \
    "https://storage.yandexcloud.net/yandex-research/ann-datasets/DEEP/query.public.10K.fbin"
fi
check_size deep/query.public.10K.fbin 3840008
if [[ ! -f deep/base.10M.fbin ]]; then
  # stream just the 10M-row prefix of base.1B.fbin and rewrite the header
  python - <<'EOF'
import struct, urllib.request
N, D = 10_000_000, 96
url = ("https://storage.yandexcloud.net/yandex-research/ann-datasets/"
       "DEEP/base.1B.fbin")
req = urllib.request.Request(url, headers={"Range": f"bytes=0-{8 + N*D*4 - 1}"})
with urllib.request.urlopen(req) as r, open("deep/base.10M.fbin", "wb") as o:
    hdr = r.read(8)
    n, d = struct.unpack("<ii", hdr)
    assert d == D, d
    o.write(struct.pack("<ii", N, D))
    left = N * D * 4
    while left:
        chunk = r.read(min(1 << 24, left))
        if not chunk:
            raise SystemExit("short read")
        o.write(chunk)
        left -= len(chunk)
EOF
fi
check_size deep/base.10M.fbin 3840000008

echo "all datasets present and size-verified under $PWD"
