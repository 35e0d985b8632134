"""Build the rendered documentation site and verify its links.

The reference ships Sphinx docs with a doc-build CI workflow
(``/root/reference/doc/conf.py``,
``/root/reference/.github/workflows/build-doc+deploy-doc.yaml``); the
counterpart here renders this repo's markdown documentation set to a
static HTML site with the stdlib-adjacent ``markdown`` package (tables,
fenced code, pygments highlighting, per-page TOC anchors) and -- the part
CI actually gates on -- validates the documentation graph:

* every intra-doc link ``[..](page.md)`` / ``[..](page.md#anchor)`` /
  ``[..](#anchor)`` resolves to an existing page and heading anchor;
* every bracketed citation key (``[HST01]``, ``[Cap+08]``, ...) used in
  any page or any package docstring resolves to an entry in
  ``docs/references.md``;
* every ``pypmc_tpu.<...>`` dotted API path named in the user guide
  imports (guards against docs drifting from the API).

Usage::

    python docs/build_site.py            # build docs/_site + check, exit 1 on breakage
    python docs/build_site.py --check    # check only, no HTML output
"""

import argparse
import importlib
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# site pages: (source path relative to repo, site-relative output path)
PAGES = [
    ("README.md", "index.html"),
    ("docs/user_guide.md", "user_guide.html"),
    ("docs/parity_map.md", "parity_map.html"),
    ("STATUS.md", "status.html"),
    ("docs/references.md", "references.html"),
    ("PERF.md", "perf.html"),
    ("docs/api/README.md", "api/index.html"),
    ("docs/api/density.md", "api/density.html"),
    ("docs/api/sampler.md", "api/sampler.html"),
    ("docs/api/mix_adapt.md", "api/mix_adapt.html"),
    ("docs/api/tools.md", "api/tools.html"),
    ("docs/api/parallel.md", "api/parallel.html"),
    ("docs/api/pipeline.md", "api/pipeline.html"),
    ("docs/api/ops.md", "api/ops.html"),
]

NAV = [
    ("index.html", "Overview"),
    ("user_guide.html", "User guide"),
    ("api/index.html", "API reference"),
    ("benchmarks.html", "Benchmarks"),
    ("parity_map.html", "Parity map"),
    ("references.html", "References"),
]

_CITE_RE = re.compile(r"\[([A-Z][A-Za-z+]*?\d{2})\]")
_LINK_RE = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 0; color: #1a1a1a; line-height: 1.55; }
.layout { display: flex; min-height: 100vh; }
nav { width: 210px; flex-shrink: 0; background: #f6f8fa;
      border-right: 1px solid #d8dee4; padding: 1.2em 1em; }
nav a { display: block; padding: .3em .5em; color: #0550ae;
        text-decoration: none; border-radius: 5px; }
nav a.current { background: #ddeeff; font-weight: 600; }
main { max-width: 54em; padding: 1.5em 2.5em 4em; overflow-x: auto; }
pre { background: #f6f8fa; padding: .8em 1em; border-radius: 6px;
      overflow-x: auto; font-size: .9em; }
code { background: #f2f3f5; padding: .08em .3em; border-radius: 4px;
       font-size: .92em; }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; margin: 1em 0; display: block;
        overflow-x: auto; }
th, td { border: 1px solid #d8dee4; padding: .35em .7em; }
th { background: #f6f8fa; }
h1, h2, h3 { line-height: 1.25; }
h2 { border-bottom: 1px solid #e4e8ec; padding-bottom: .25em; }
a { color: #0550ae; }
""".strip()


def github_anchor(heading_text):
    """GitHub/python-markdown(toc) style anchor from a heading."""
    s = re.sub(r"<[^>]+>", "", heading_text)
    s = re.sub(r"[`*_]", "", s).strip().lower()
    s = re.sub(r"[^\w\- ]", "", s)
    return s.replace(" ", "-")


def collect_anchors(md_text):
    anchors = set()
    in_code = False
    for line in md_text.splitlines():
        if line.strip().startswith("```"):
            in_code = not in_code
            continue
        if not in_code and line.startswith("#"):
            anchors.add(github_anchor(line.lstrip("#")))
    return anchors


def check(pages_md, ref_keys):
    """Return a list of human-readable breakage strings."""
    problems = []
    anchors = {src: collect_anchors(text) for src, text in pages_md.items()}
    known_sources = set(pages_md)

    for src, text in pages_md.items():
        base = os.path.dirname(src)
        # strip fenced code before link/citation scanning
        stripped = re.sub(r"```.*?```", "", text, flags=re.S)
        for target in _LINK_RE.findall(stripped):
            if target.startswith(("http://", "https://", "mailto:")):
                continue
            frag = None
            if "#" in target:
                target, frag = target.split("#", 1)
            if target == "":
                if frag and frag not in anchors[src]:
                    problems.append("%s: broken local anchor #%s"
                                    % (src, frag))
                continue
            norm = os.path.normpath(os.path.join(base, target))
            if norm in known_sources:
                if frag and frag not in anchors[norm]:
                    problems.append("%s: broken anchor %s#%s"
                                    % (src, norm, frag))
            elif not os.path.exists(os.path.join(REPO, norm)):
                problems.append("%s: broken link %s" % (src, target))
            elif norm.endswith(".md"):
                # an .md link to a repo file OUTSIDE the site would render
                # as a dead link in the deployed site -- add it to PAGES
                problems.append("%s: link %s targets a markdown file not "
                                "in the rendered site (add it to PAGES)"
                                % (src, target))
        for key in set(_CITE_RE.findall(stripped)):
            if key not in ref_keys:
                problems.append("%s: citation [%s] not in docs/references.md"
                                % (src, key))

    # citation keys in package docstrings must resolve too
    for root, _dirs, files in os.walk(os.path.join(REPO, "pypmc_tpu")):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as fh:
                body = fh.read()
            for key in set(_CITE_RE.findall(body)):
                if key not in ref_keys:
                    problems.append(
                        "%s: citation [%s] not in docs/references.md"
                        % (os.path.relpath(path, REPO), key))

    # dotted API paths in the user guide must import
    guide = pages_md.get("docs/user_guide.md", "")
    for dotted in set(re.findall(r"`(pypmc_tpu(?:\.\w+)+)`", guide)):
        mod_path = dotted.split(".")
        for split in range(len(mod_path), 0, -1):
            try:
                obj = importlib.import_module(".".join(mod_path[:split]))
            except ImportError:
                continue
            ok = True
            for attr in mod_path[split:]:
                if not hasattr(obj, attr):
                    ok = False
                    break
                obj = getattr(obj, attr)
            if ok:
                break
        else:
            ok = False
        if not ok:
            problems.append("docs/user_guide.md: API path %s does not "
                            "resolve" % dotted)
    return problems


def build(pages_md, out_dir):
    import markdown

    html_names = dict(PAGES)
    for src, text in pages_md.items():
        out_rel = html_names[src]
        depth = out_rel.count("/")
        prefix = "../" * depth
        md = markdown.Markdown(
            extensions=["tables", "fenced_code", "toc", "codehilite"],
            extension_configs={
                "toc": {"slugify": lambda v, s: github_anchor(v)},
                "codehilite": {"guess_lang": False, "noclasses": True},
            })
        # rewrite intra-doc .md links to the rendered page names
        def sub_link(m, _src=src):
            whole, target = m.group(0), m.group(1)
            if target.startswith(("http://", "https://", "mailto:", "#")):
                return whole
            t, frag = (target.split("#", 1) + [None])[:2]
            norm = os.path.normpath(os.path.join(os.path.dirname(_src), t))
            if norm in html_names:
                new = prefix + html_names[norm]
                if frag:
                    new += "#" + frag
                return whole.replace(target, new)
            return whole

        text_rw = _LINK_RE.sub(sub_link, text)
        body = md.convert(text_rw)
        title = next((l.lstrip("# ").strip()
                      for l in text.splitlines() if l.startswith("#")),
                     os.path.basename(src))
        nav_html = "".join(
            '<a href="%s%s"%s>%s</a>'
            % (prefix, href, ' class="current"' if href == out_rel else "",
               label)
            for href, label in NAV)
        page = ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
                "<title>%s — pypmc_tpu</title><style>%s</style></head>"
                "<body><div class='layout'><nav><h3>pypmc_tpu</h3>%s</nav>"
                "<main>%s</main></div></body></html>"
                % (title, _CSS, nav_html, body))
        out_path = os.path.join(out_dir, out_rel)
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as fh:
            fh.write(page)
    return len(pages_md)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="link/citation check only, write no HTML")
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "_site"))
    args = ap.parse_args()

    pages_md = {}
    for src, _out in PAGES:
        path = os.path.join(REPO, src)
        if not os.path.exists(path):
            print("MISSING PAGE: %s" % src)
            sys.exit(1)
        with open(path) as fh:
            pages_md[src] = fh.read()

    with open(os.path.join(REPO, "docs", "references.md")) as fh:
        ref_keys = set(_CITE_RE.findall(fh.read()))
    print("reference keys: %s" % ", ".join(sorted(ref_keys)))

    problems = check(pages_md, ref_keys)
    for p in problems:
        print("BROKEN: %s" % p)

    if not args.check:
        n = build(pages_md, args.out)
        print("rendered %d pages -> %s" % (n, args.out))

    if problems:
        print("FAIL: %d broken link(s)/citation(s)" % len(problems))
        sys.exit(1)
    print("OK: all links and citation keys resolve")


if __name__ == "__main__":
    main()
