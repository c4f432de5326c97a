"""The transcript scraper: a copy of ``rtts/data/download.py``.

An index page's transcript links (``parse_transcript_index``), each page's
media URL and timed utterances (``parse_media_url``,
``parse_transcript_page``: ``data-start``/``data-end`` paragraphs or
speaker paragraphs with inline ``(hh:mm:ss)`` stamps), the media download
and the ``transcripts.txt`` that ``preprocess_corpus`` reads.  Fetching
needs network access; without it every fetch raises an error that points
at ``rtts_torch.data.corpus.generate_corpus``.  The parsers are held equal
to the JAX package's on ``tests/fixtures/scrape/``.
"""

from __future__ import annotations

import html as _html
import json
import pathlib
import re
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class TranscriptEntry:
    utt_id: str
    text: str
    media_url: Optional[str] = None
    # transcript timing within the media (seconds), when the page carries it
    start_s: Optional[float] = None
    end_s: Optional[float] = None
    speaker: Optional[str] = None


def fetch_url(url: str, timeout: float = 20.0) -> bytes:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read()
    except (urllib.error.URLError, OSError) as e:
        raise RuntimeError(
            f"network fetch failed for {url!r}. Without network access, "
            "use `rtts_torch.data.corpus.generate_corpus` to build the "
            "synthetic corpus, or place wav+transcript files under the data "
            "dir manually (wavs/*.wav + transcripts.txt with `id|text` lines)."
        ) from e


# attribute value in single or double quotes, any tag/attr case
_HREF = re.compile(r"""href\s*=\s*(?:"([^"]+)"|'([^']+)')""", re.I)
_SRC = re.compile(
    r"""<(?:video|source|audio)\b[^>]*?\bsrc\s*=\s*(?:"([^"]+)"|'([^']+)')""",
    re.I | re.S)
_MEDIA_EXT = re.compile(
    r"\.(?:mp4|webm|mkv|m4a|mp3|wav|ogg)(?:$|\?)", re.I)
# "Speaker 2:" / "Dr. Jane Smith:" label at the head of a paragraph
_SPEAKER = re.compile(r"^\s*((?:Speaker\s+\d+|[A-Z][\w.'-]*"
                      r"(?:\s+[A-Z][\w.'-]*){0,3}))\s*:\s*")
# inline "(mm:ss)" / "(hh:mm:ss)" timestamp
_STAMP = re.compile(r"\(\s*(\d{1,2}):(\d{2})(?::(\d{2}))?\s*\)")


def _decode(html_bytes: bytes) -> str:
    return html_bytes.decode("utf-8", errors="ignore")


def _strip_blocks(text: str) -> str:
    """Drop script/style/head/nav/footer blocks — page chrome that would
    otherwise contribute junk paragraphs."""
    for tag in ("script", "style", "head", "nav", "footer"):
        text = re.sub(rf"<{tag}\b.*?</{tag}\s*>", "", text, flags=re.S | re.I)
    return text


def parse_transcript_index(html: bytes,
                           base_url: Optional[str] = None) -> List[str]:
    """Extract transcript page links from an index page.

    Any ``href`` whose path mentions ``transcript`` counts (the reference's
    rev.com-style index layout); matching is case-insensitive over single-
    or double-quoted attributes, entities are unescaped, relative links
    resolve against ``base_url``, fragments-only links are skipped, and
    duplicates collapse preserving first-seen order."""
    text = _strip_blocks(_decode(html))
    out: List[str] = []
    seen = set()
    for m in _HREF.finditer(text):
        link = _html.unescape(m.group(1) or m.group(2)).strip()
        if not link or link.startswith("#"):
            continue
        path = urllib.parse.urlparse(link).path
        if "transcript" not in path.lower():
            continue
        if base_url:
            link = urllib.parse.urljoin(base_url, link)
        if link not in seen:
            seen.add(link)
            out.append(link)
    return out


def parse_media_url(html: bytes,
                    base_url: Optional[str] = None) -> Optional[str]:
    """Extract the page's media (video/audio) URL: <video>/<source>/<audio>
    ``src`` first, then any link to a common media extension."""
    text = _decode(html)
    m = _SRC.search(text)
    if m:
        url = _html.unescape(m.group(1) or m.group(2))
        return urllib.parse.urljoin(base_url, url) if base_url else url
    for hm in _HREF.finditer(text):
        link = _html.unescape(hm.group(1) or hm.group(2))
        if _MEDIA_EXT.search(urllib.parse.urlparse(link).path + "?"):
            return urllib.parse.urljoin(base_url, link) if base_url else link
    return None


def _stamp_seconds(m: "re.Match") -> float:
    a, b, c = m.group(1), m.group(2), m.group(3)
    if c is None:
        return int(a) * 60.0 + int(b)
    return int(a) * 3600.0 + int(b) * 60.0 + int(c)


def parse_transcript_page(html: bytes, utt_prefix: str,
                          base_url: Optional[str] = None
                          ) -> List[TranscriptEntry]:
    """Extract utterance texts + timings from a transcript page.

    Two timing layouts (both present in the golden fixtures):

    - ``<p data-start="12.5" data-end="15.9">`` attributes — explicit
      [start, end) per paragraph.
    - rev.com-style speaker paragraphs — ``Speaker 1: (00:03) text`` with
      the timestamp inline (often wrapped in an <a> jump link): the stamp
      becomes the utterance's ``start_s`` and the NEXT paragraph's stamp
      its ``end_s`` (the final utterance has no end and is written as an
      untimed line downstream).

    Speaker labels are captured into ``speaker`` and stripped from the
    text; inline markup is dropped; entities are unescaped."""
    raw = _strip_blocks(_decode(html))
    media = parse_media_url(html, base_url)
    paras = []
    for m in re.finditer(r"<p\b([^>]*)>(.*?)</p\s*>", raw, flags=re.S | re.I):
        attrs, body = m.group(1), m.group(2)
        clean = _html.unescape(re.sub(r"<[^>]+>", " ", body))
        # tags became spaces; collapse runs and re-attach punctuation that
        # a closing inline tag (</em>.) separated from its word
        clean = re.sub(r"\s+", " ", clean).strip()
        clean = re.sub(r"\s+([.,;:!?])", r"\1", clean)
        if not clean:
            continue
        ts = re.search(r"""data-start\s*=\s*["']([\d.]+)["']""", attrs, re.I)
        te = re.search(r"""data-end\s*=\s*["']([\d.]+)["']""", attrs, re.I)
        start = float(ts.group(1)) if ts else None
        end = float(te.group(1)) if te else None
        speaker = None
        sm = _SPEAKER.match(clean)
        if sm:
            speaker = sm.group(1)
            clean = clean[sm.end():].strip()
        if start is None:
            stamp = _STAMP.match(clean)
            if stamp:
                start = _stamp_seconds(stamp)
                clean = clean[stamp.end():].strip()
        # drop any remaining inline stamps (mid-paragraph jump links)
        clean = re.sub(_STAMP, "", clean)
        clean = re.sub(r"\s+", " ", clean).strip()
        if not clean:
            continue
        paras.append(TranscriptEntry("", clean, media_url=media,
                                     start_s=start, end_s=end,
                                     speaker=speaker))
    # fill missing ends from the next paragraph's start (speaker layout)
    for i, e in enumerate(paras):
        if e.end_s is None and e.start_s is not None:
            nxt = paras[i + 1].start_s if i + 1 < len(paras) else None
            if nxt is not None and nxt > e.start_s:
                e.end_s = nxt
        e.utt_id = f"{utt_prefix}{i:04d}"
    return paras


def download_media(entries: List[TranscriptEntry], out_dir: str) -> List[str]:
    """Fetch each distinct media URL to <out_dir>/media/ (offline: raises
    the actionable fetch_url error).  Returns the local file paths."""
    out = pathlib.Path(out_dir) / "media"
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    seen = {}
    for e in entries:
        if not e.media_url or e.media_url in seen:
            continue
        name = pathlib.PurePosixPath(e.media_url.split("?")[0]).name
        path = out / (name or f"media{len(seen):03d}")
        path.write_bytes(fetch_url(e.media_url))
        seen[e.media_url] = str(path)
        paths.append(str(path))
    return paths


def write_transcripts(entries: List[TranscriptEntry],
                      out_path: pathlib.Path) -> None:
    """Entries -> the transcripts.txt layouts ``preprocess_corpus``
    consumes: timed entries with a media source produce
    ``utt|source|start|end|text`` lines (cut out of the long recording),
    untimed ones plain ``utt|text``."""
    with open(out_path, "w") as f:
        for e in entries:
            if e.start_s is not None and e.end_s is not None and e.media_url:
                src = pathlib.PurePosixPath(
                    e.media_url.split("?")[0]).name
                f.write(f"{e.utt_id}|media/{src}|{e.start_s}|{e.end_s}|"
                        f"{e.text}\n")
            else:
                f.write(f"{e.utt_id}|{e.text}\n")


def download_corpus(index_url: str, out_dir: str,
                    fetch_media: bool = True) -> str:
    """Scrape transcript index -> fetch pages (+ media files) -> write
    transcripts.txt.  Pages carrying per-paragraph timings produce timed
    ``utt|source|start|end|text`` lines that preprocess cuts directly from
    the extracted audio; untimed pages produce plain
    ``utt|text`` lines.  (Raises a helpful error offline; see fetch_url.)"""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    index = fetch_url(index_url)
    links = parse_transcript_index(index, base_url=index_url)
    entries: List[TranscriptEntry] = []
    for j, link in enumerate(links):
        page = fetch_url(link)
        entries.extend(parse_transcript_page(page, f"doc{j:03d}_",
                                             base_url=link))
    media_paths = download_media(entries, out_dir) if fetch_media else []
    write_transcripts(entries, out / "transcripts.txt")
    with open(out / "download_meta.json", "w") as f:
        json.dump({"index_url": index_url, "n_entries": len(entries),
                   "media_files": media_paths}, f)
    return str(out / "transcripts.txt")
