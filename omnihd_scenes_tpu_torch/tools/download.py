"""Threaded dataset downloader (counterpart of
``omnihd_scenes_tpu/tools/download.py``).

Parity target: ``download_oss.py:24-148`` — downloads the dataset
archive list with a JSON key file and a thread pool.  Generic
HTTP(S)/OSS-URL implementation with resume + integrity size check
(any ``urllib`` URL, ``file://`` included).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor, as_completed


def _total_size(resp, partial: bool):
    """The whole file's size from the response headers (None if the
    server sends none)."""
    if partial:
        total = (resp.headers.get('Content-Range') or '').rpartition('/')[2]
        return int(total) if total.isdigit() else None
    length = resp.headers.get('Content-Length')
    return int(length) if length and length.isdigit() else None


def _download_one(url: str, out_path: str, chunk: int = 1 << 20) -> str:
    """``url`` to ``out_path`` through ``out_path + '.part'``: an existing
    part is resumed with a Range request (a server that ignores it, as
    ``file://`` does, sends the whole file, whose first bytes are then
    skipped), and the finished file must have the size the server
    announced, or the part stays for the next attempt."""
    import urllib.request

    os.makedirs(osp.dirname(out_path) or '.', exist_ok=True)
    tmp = out_path + '.part'
    start = osp.getsize(tmp) if osp.exists(tmp) else 0
    req = urllib.request.Request(url)
    if start:
        req.add_header('Range', f'bytes={start}-')
    with urllib.request.urlopen(req) as resp, open(tmp, 'ab') as f:
        partial = getattr(resp, 'status', None) == 206
        total = _total_size(resp, partial)
        skip = 0 if partial else start
        while True:
            buf = resp.read(chunk)
            if not buf:
                break
            if skip:
                cut = min(skip, len(buf))
                buf, skip = buf[cut:], skip - cut
            f.write(buf)
    size = osp.getsize(tmp)
    if total is not None and size != total:
        raise IOError(f'{url}: {size} bytes in {tmp}, the server announced '
                      f'{total}')
    os.replace(tmp, out_path)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description='Download the dataset')
    p.add_argument('--key-file', required=True,
                   help='JSON: {"files": [{"url":..., "path":...}, ...]}')
    p.add_argument('--out-dir', default='data/NewScenes_Final')
    p.add_argument('--workers', type=int, default=4)
    args = p.parse_args(argv)

    with open(args.key_file) as f:
        spec = json.load(f)
    files = spec['files']
    print(f'downloading {len(files)} files with {args.workers} workers')

    with ThreadPoolExecutor(max_workers=args.workers) as ex:
        futs = {ex.submit(_download_one, item['url'],
                          osp.join(args.out_dir, item['path'])): item
                for item in files}
        for fut in as_completed(futs):
            item = futs[fut]
            try:
                print('done', fut.result())
            except Exception as e:
                print('FAILED', item['path'], e)


if __name__ == '__main__':
    main()
