"""REST API server (the port of ``framewright_tpu.api``, on the standard
library's ``ThreadingHTTPServer``): JSON over HTTP, jobs restored on a
worker thread through the port's ``BatchQueueProcessor`` against the
SQLite job store, requests rate-limited by ``security.RateLimiter``.

Endpoints (JAX's):
    GET  /api/health
    GET  /api/hardware
    GET  /api/presets
    GET  /api/models
    GET  /api/recipes
    GET  /api/config_schema   every Config field, grouped (the settings editor)
    GET  /api/jobs            list
    POST /api/jobs            {"source": ..., "output": ..., "config": {...}}
    GET  /api/jobs/<id>
    GET  /api/jobs/<id>/log   the job's log lines
    DELETE /api/jobs/<id>
    POST /api/analyze         {"source": ...}
    POST /api/recommend       analysis -> preset, overrides, config
    POST /api/preview         queue a preview segment render
    GET  /api/preview/<task>, /api/preview-status
    GET  /api/frame           a frame as PNG (compare slider, gallery)
    GET  /api/events          server-sent events: the job list on each change
    GET  /                    the HTML dashboard

``device`` (``auto``: the card; ``DeviceError`` without one) is the
device of every job and preview whose config does not name one.
``/api/frame`` also takes ``job=<id>``: frame ``t`` of that job's output
once it is completed (JAX serves a registered source's frames and a
preview's only).
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from framewright_tpu_torch.batch import BatchQueueProcessor
from framewright_tpu_torch.persistence import JobStore
from framewright_tpu_torch.security import RateLimiter

logger = logging.getLogger(__name__)


def _task_dict(task, source: str = "") -> dict:
    """A preview task as JSON; ``source`` travels with it so the dashboard
    can build ``/api/frame`` URLs."""
    return {"task_id": task.task_id, "status": task.status,
            "progress": task.progress, "start": task.start,
            "n_frames": task.n_frames, "source": source,
            "output": str(task.output) if task.output else None,
            "error": task.error}


def _job_dict(j) -> dict:
    return {"job_id": j.job_id, "source": j.source, "output": j.output,
            "state": j.state, "stage": j.stage, "frames_done": j.frames_done,
            "total_frames": j.total_frames, "error": j.error,
            # the submitted config, so the settings editor shows what a
            # queued job will run with
            "config": j.config}


_DASHBOARD_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>framewright-tpu-torch</title>
<style>body{font-family:system-ui;margin:2rem;background:#14161a;color:#e7e7e7}
table{border-collapse:collapse;width:100%}td,th{border-bottom:1px solid #333;
padding:.45rem .7rem;text-align:left}.state-completed{color:#6c6}
.state-failed{color:#e66}.state-running{color:#fc6}
progress{width:140px}
fieldset{border:1px solid #333;border-radius:6px;margin:1rem 0;
padding:.8rem 1rem}legend{color:#9ab}input,select,button{background:#1e2127;
color:#e7e7e7;border:1px solid #444;border-radius:4px;padding:.35rem .55rem}
button{cursor:pointer}button:hover{border-color:#9ab}
#msg{margin-left:.8rem;color:#9ab}
.cmp{position:relative;display:inline-block;margin:.6rem 0}
.cmp img{display:block;max-width:560px}
.cmp .after{position:absolute;top:0;left:0;clip-path:inset(0 50% 0 0)}
.cmp .lbl{position:absolute;top:4px;font-size:.72rem;background:#0009;
padding:1px 6px;border-radius:3px}.cmp .lbl.b{right:6px}
.cmp .lbl.a{left:6px}
.cmp input{position:absolute;left:0;bottom:-1.4rem;width:100%}
.gal{display:flex;gap:6px;margin:2rem 0 .6rem}
.gal .pair{cursor:pointer;text-align:center;font-size:.68rem;color:#9ab}
.gal img{display:block;max-width:132px;border:1px solid #333}
.gal .pair.sel img{border-color:#6cf}</style></head><body>
<h1>framewright-tpu-torch</h1>
<fieldset><legend>submit a restore job</legend>
<form id="submit" onsubmit="return submitJob(event)">
<input id="src" placeholder="/path/to/video.y4m" size="38" required>
<select id="preset"><option value="">default config</option></select>
<select id="recipe"><option value="">no recipe</option></select>
<label><input type="checkbox" id="dn"> denoise</label>
<label><input type="checkbox" id="fr"> faces</label>
<label><input type="checkbox" id="it"> interpolate</label>
<button>Submit</button>
<button type="button" onclick="previewJob()">Preview 48f</button>
<button type="button" onclick="analyzeSrc()">Analyze</button>
<span id="msg"></span>
</form>
<pre id="analysis" style="display:none;max-height:14rem;overflow:auto;
background:#1e2127;padding:.6rem;border-radius:4px"></pre>
<details id="allset" ontoggle="loadSchema()"><summary>all settings
(full config — only changed values are submitted)</summary>
<div id="cfgpanel" style="display:flex;flex-wrap:wrap;gap:.6rem"></div>
</details></fieldset>
<fieldset><legend>guided restore (analyze &rarr; recommend &rarr; restore)</legend>
<form onsubmit="return guidedAnalyze(event)">
<input id="gsrc" placeholder="/path/to/video.y4m" size="38" required>
<button>Analyze &amp; recommend</button>
<span id="gmsg"></span></form>
<div id="gpanel" style="display:none">
<div id="gsummary" style="margin:.6rem 0;color:#9ab"></div>
<table id="gsettings" style="width:auto"></table>
<button type="button" onclick="guidedRestore()" style="margin-top:.6rem">
Restore with these settings</button>
</div></fieldset>
<details><summary>hardware</summary>
<pre id="hardware">loading...</pre></details>
<details ontoggle="loadGuide()"><summary>model guide (which model for
which content)</summary>
<table id="mguide" style="width:auto"></table></details>
<table id="jobs"><tr><th>Job</th><th>Source</th><th>State</th>
<th>Progress</th></tr></table>
<pre id="joblog" style="display:none;max-height:16rem;overflow:auto;
background:#1e2127;padding:.6rem;border-radius:4px"></pre>
<h3 id="pvh" style="display:none">previews</h3>
<table id="previews" style="display:none"><tr><th>Task</th><th>Status</th>
<th>Output</th></tr></table>
<script>
async function loadPresets(){
  const r = await fetch('/api/presets');
  const sel = document.getElementById('preset');
  for (const [name, desc] of Object.entries(await r.json())){
    const o = document.createElement('option');
    o.value = name; o.textContent = name + (desc ? ' - ' + desc : '');
    sel.appendChild(o);
  }
}
async function loadRecipes(){
  const r = await fetch('/api/recipes');
  const sel = document.getElementById('recipe');
  for (const [name, desc] of Object.entries(await r.json())){
    const o = document.createElement('option');
    o.value = name; o.textContent = name + (desc ? ' - ' + desc : '');
    sel.appendChild(o);
  }
}
async function loadHardware(){
  const r = await fetch('/api/hardware');
  document.getElementById('hardware').textContent =
    JSON.stringify(await r.json(), null, 2);
}
// model-selection guide (reference ui.py "AI Model Guide")
let guideLoaded = false;
async function loadGuide(){
  if (guideLoaded) return;
  guideLoaded = true;
  const r = await fetch('/api/models');
  const t = document.getElementById('mguide');
  const hdr = t.insertRow();
  for (const h of ['model', 'scale', 'when to use'])
    hdr.insertCell().textContent = h;
  for (const [name, d] of Object.entries(await r.json())){
    if (!d.guide) continue;
    const row = t.insertRow();
    row.insertCell().textContent = name;
    row.insertCell().textContent = d.scale + 'x';
    row.insertCell().textContent = d.guide;
  }
}
async function analyzeSrc(){
  const r = await fetch('/api/analyze', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({source: document.getElementById('src').value})});
  const box = document.getElementById('analysis');
  box.style.display = '';
  box.textContent = JSON.stringify(await r.json(), null, 2);
}
// full settings editor (reference ui.py settings panels): every Config
// flag grouped as served by /api/config_schema; values that differ
// from the default ride the job config
let schemaLoaded = false;
async function loadSchema(){
  if (schemaLoaded || !document.getElementById('allset').open) return;
  schemaLoaded = true;
  const r = await fetch('/api/config_schema');
  const panel = document.getElementById('cfgpanel');
  for (const g of await r.json()){
    const fs = document.createElement('fieldset');
    fs.style.margin = '0';
    const lg = document.createElement('legend');
    lg.textContent = g.group; fs.appendChild(lg);
    for (const f of g.fields){
      const row = document.createElement('div');
      const lab = document.createElement('label');
      lab.textContent = f.name + ' ';
      let inp;
      if (f.type === 'bool'){
        inp = document.createElement('input');
        inp.type = 'checkbox'; inp.checked = f.default;
      } else if (f.choices){
        inp = document.createElement('select');
        for (const c of f.choices){
          const o = document.createElement('option');
          o.value = c; o.textContent = c; inp.appendChild(o);
        }
        inp.value = f.default;
      } else {
        inp = document.createElement('input');
        inp.value = f.default; inp.size = 10;
        if (f.type !== 'str') inp.type = 'text';
      }
      inp.className = 'cfgf';
      inp.dataset.key = f.name; inp.dataset.kind = f.type;
      inp.dataset.def = JSON.stringify(f.default);
      lab.appendChild(inp); row.appendChild(lab); fs.appendChild(row);
    }
    panel.appendChild(fs);
  }
}
function jobConfig(){
  const cfg = {};
  for (const inp of document.querySelectorAll('.cfgf')){
    const k = inp.dataset.key, kind = inp.dataset.kind;
    let v;
    if (inp.type === 'checkbox') v = inp.checked;
    else if (kind === 'int') v = parseInt(inp.value);
    else if (kind === 'float') v = parseFloat(inp.value);
    else v = inp.value;
    if (JSON.stringify(v) !== inp.dataset.def && !Number.isNaN(v))
      cfg[k] = v;
  }
  if (document.getElementById('dn').checked) cfg.denoise = true;
  if (document.getElementById('fr').checked) cfg.face_restore = true;
  if (document.getElementById('it').checked) cfg.interpolation = true;
  const recipe = document.getElementById('recipe').value;
  if (recipe) cfg.recipe = recipe;
  return cfg;
}
async function submitJob(ev){
  ev.preventDefault();
  const body = {source: document.getElementById('src').value,
                config: jobConfig()};
  const preset = document.getElementById('preset').value;
  if (preset) body.config.preset = preset;
  const r = await fetch('/api/jobs', {method:'POST',
    headers:{'Content-Type':'application/json'}, body: JSON.stringify(body)});
  const d = await r.json();
  document.getElementById('msg').textContent =
    r.ok ? 'queued ' + d.job_id : 'error: ' + d.error;
  return false;
}
const pvTasks = {};
async function previewJob(){
  const body = {source: document.getElementById('src').value,
                start: 0, n_frames: 48, config: jobConfig()};
  const r = await fetch('/api/preview', {method:'POST',
    headers:{'Content-Type':'application/json'}, body: JSON.stringify(body)});
  const d = await r.json();
  document.getElementById('msg').textContent =
    r.ok ? 'preview ' + d.task_id : 'error: ' + d.error;
  if (r.ok){ pvTasks[d.task_id] = d; pollPreviews(); }
  return false;
}
async function pollPreviews(){
  const t = document.getElementById('previews');
  document.getElementById('pvh').style.display = '';
  t.style.display = '';
  for (const id of Object.keys(pvTasks)){
    const r = await fetch('/api/preview/' + id);
    if (r.ok) pvTasks[id] = await r.json();
  }
  t.textContent = '';
  const hdr = t.insertRow();
  for (const h of ['Task','Status','Output'])
    hdr.insertCell().textContent = h;
  for (const d of Object.values(pvTasks)){
    const row = t.insertRow();
    row.insertCell().textContent = d.task_id;
    row.insertCell().textContent = d.status +
      (d.status === 'rendering' ? ' ' + Math.round(d.progress*100) + '%' : '');
    row.insertCell().textContent = d.output || d.error || '';
    if (d.status === 'done') renderCompare(d);
  }
  if (Object.values(pvTasks).some(d =>
      d.status === 'queued' || d.status === 'rendering'))
    setTimeout(pollPreviews, 1500);
}
// before/after comparison slider (server-rendered PNG crops from
// /api/frame; restored side clipped by the range input)
function renderCompare(d){
  if (document.getElementById('cmp-' + d.task_id)) return;
  const src = encodeURIComponent(
    d.source || document.getElementById('src').value);
  const mid = (d.start || 0) + Math.floor((d.n_frames || 48) / 2);
  const div = document.createElement('div');
  div.className = 'cmp'; div.id = 'cmp-' + d.task_id;
  const before = document.createElement('img');
  before.src = '/api/frame?source=' + src + '&t=' + mid;
  const after = document.createElement('img');
  after.className = 'after';
  after.src = '/api/frame?source=' + src + '&t=' + mid +
              '&task=' + encodeURIComponent(d.task_id);
  const la = document.createElement('span');
  la.className = 'lbl a'; la.textContent = 'restored';
  const lb = document.createElement('span');
  lb.className = 'lbl b'; lb.textContent = 'original';
  const range = document.createElement('input');
  range.type = 'range'; range.min = 0; range.max = 100; range.value = 50;
  range.oninput = () =>
    after.style.clipPath = 'inset(0 ' + (100 - range.value) + '% 0 0)';
  div.append(before, after, la, lb, range);
  document.getElementById('previews').after(div);
  // gallery strip: restored thumbnails across the segment (reference
  // ui.py gallery panel); click loads that frame into the slider
  const gal = document.createElement('div');
  gal.className = 'gal'; gal.id = 'gal-' + d.task_id;
  const n = d.n_frames || 48, start = d.start || 0;
  const picks = [...new Set([0, 1, 2, 3].map(i =>
    start + Math.min(n - 1, Math.floor(i * (n - 1) / 3))))];
  // the slider shows frame `mid`, which is never among the picks —
  // mark the pick closest to it as the initial selection
  const sel = picks.reduce((a, b) =>
    Math.abs(b - mid) < Math.abs(a - mid) ? b : a);
  for (const t of picks){
    const p = document.createElement('div');
    p.className = 'pair' + (t === sel ? ' sel' : '');
    const im = document.createElement('img');
    im.src = '/api/frame?source=' + src + '&t=' + t +
             '&task=' + encodeURIComponent(d.task_id);
    const cap = document.createElement('div');
    cap.textContent = 'frame ' + t;
    p.append(im, cap);
    p.onclick = () => {
      before.src = '/api/frame?source=' + src + '&t=' + t;
      after.src = im.src;
      for (const q of gal.children) q.classList.remove('sel');
      p.classList.add('sel');
    };
    gal.appendChild(p);
  }
  div.after(gal);
}
// guided workflow: analyze -> editable recommendation -> one-click job
let gRec = null;
async function guidedAnalyze(ev){
  ev.preventDefault();
  const msg = document.getElementById('gmsg');
  msg.textContent = 'analyzing...';
  const r = await fetch('/api/recommend', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({source: document.getElementById('gsrc').value})});
  const d = await r.json();
  if (!r.ok){ msg.textContent = 'error: ' + d.error; return false; }
  gRec = d; msg.textContent = '';
  const a = d.analysis;
  const np = a.noise_profile || {};
  document.getElementById('gsummary').textContent =
    'content: ' + a.content_type + ' | quality: ' + a.quality_score +
    '/100 | degradations: ' + (a.degradations.join(', ') || 'none') +
    ' | noise: ' + (np.dominant_type || '?') +
    ' (σ ' + (np.luma_sigma ?? '?') + ')' +
    ' | recommended preset: ' + d.preset;
  const t = document.getElementById('gsettings');
  t.textContent = '';
  const hdr = t.insertRow();
  for (const h of ['setting (differs from preset)', 'value'])
    hdr.insertCell().textContent = h;
  for (const [k, v] of Object.entries(d.overrides)){
    const row = t.insertRow();
    row.insertCell().textContent = k;
    const cell = row.insertCell();
    const inp = document.createElement('input');
    if (typeof v === 'boolean'){
      inp.type = 'checkbox'; inp.checked = v;
    } else { inp.value = v; inp.size = 12; }
    inp.dataset.key = k; inp.dataset.kind = typeof v;
    cell.appendChild(inp);
  }
  document.getElementById('gpanel').style.display = '';
  return false;
}
async function guidedRestore(){
  if (!gRec) return;
  const cfg = {preset: gRec.preset};
  for (const inp of document.querySelectorAll('#gsettings input')){
    const k = inp.dataset.key;
    if (inp.type === 'checkbox') cfg[k] = inp.checked;
    else if (inp.dataset.kind === 'number') cfg[k] = parseFloat(inp.value);
    else cfg[k] = inp.value;
  }
  const r = await fetch('/api/jobs', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({source: document.getElementById('gsrc').value,
                          config: cfg})});
  const d = await r.json();
  document.getElementById('gmsg').textContent =
    r.ok ? 'queued ' + d.job_id : 'error: ' + d.error;
}
loadPresets(); loadRecipes(); loadHardware();
function render(jobs){
  const t = document.getElementById('jobs');
  t.textContent = '';
  const hdr = t.insertRow();
  for(const h of ['Job','Source','State','Progress']){
    const th = document.createElement('th'); th.textContent = h;
    hdr.appendChild(th);
  }
  for(const j of jobs){
    const pct = j.total_frames ? Math.round(100*j.frames_done/j.total_frames) : 0;
    const row = t.insertRow();
    row.style.cursor = 'pointer';
    row.onclick = () => toggleLog(j.job_id);
    // textContent only — job fields are user input (stored-XSS surface)
    row.insertCell().textContent = j.job_id;
    row.insertCell().textContent = j.source;
    const st = row.insertCell();
    st.textContent = j.state +
      (j.state === 'running' && j.stage ? ' · ' + j.stage : '');
    st.className = 'state-' + String(j.state).replace(/[^a-z]/g, '');
    const pc = row.insertCell();
    const bar = document.createElement('progress');
    bar.max = 100; bar.value = pct;
    pc.appendChild(bar);
    pc.appendChild(document.createTextNode(' ' + j.frames_done + 'f'));
  }
}
async function refresh(){
  const r = await fetch('/api/jobs'); render(await r.json());
}
// live log panel: click a job row to follow its log (reference ui.py
// live-log panel)
let logJob = null;
async function toggleLog(jid){
  const box = document.getElementById('joblog');
  if (logJob === jid){ logJob = null; box.style.display = 'none'; return; }
  logJob = jid; box.style.display = '';
  pollLog();
}
async function pollLog(){
  if (!logJob) return;
  const box = document.getElementById('joblog');
  const r = await fetch('/api/jobs/' + logJob + '/log');
  if (r.ok){
    const d = await r.json();
    box.textContent = 'log ' + logJob + '\n' +
      (d.lines.length ? d.lines.join('\n') : '(no log lines yet)');
    box.scrollTop = box.scrollHeight;
  }
  setTimeout(pollLog, 1500);
}
// push channel: server-sent events stream job updates; fall back to
// polling when the stream drops
const es = new EventSource('/api/events');
es.onmessage = (e) => { render(JSON.parse(e.data)); };
es.onerror = () => { setTimeout(refresh, 2000); };
refresh();
</script></body></html>"""

class APIServer:
    def __init__(self, db_path: Path, host: str = "127.0.0.1", port: int = 8765,
                 rate_per_s: float = 20.0, device: str = "auto"):
        from framewright_tpu_torch.hw import resolve_device

        self.device = resolve_device(device).type
        self.store = JobStore(db_path)
        self.queue = BatchQueueProcessor(self.store)
        self.limiter = RateLimiter(rate_per_s=rate_per_s, burst=int(rate_per_s * 2))
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()       # a job was submitted
        self._previews = {}                  # source -> PreviewServer
        self._frame_cache = {}               # (media, t) -> PNG bytes

    def job_config(self, cdict: dict):
        """A posted config: ``recipe`` (the recipe's config) or ``preset``
        under the other keys, else the keys alone; on the server's device
        unless it names one. ``ConfigError`` for a bad one."""
        from framewright_tpu_torch.config import Config, with_model_scale
        from framewright_tpu_torch.recipes import recipe_config

        cdict = dict(cdict)
        preset = cdict.pop("preset", "")
        recipe = cdict.pop("recipe", "")
        cdict.setdefault("device_platform", self.device)
        if recipe:
            return recipe_config(recipe, **cdict)
        if preset:
            return Config.from_preset(preset, **cdict)
        return Config.from_dict(with_model_scale(cdict))

    def _read_frame_png(self, media: Path, t: int, max_side: int = 640) -> Optional[bytes]:
        """Frame ``t`` of a video as PNG bytes, every k-th pixel so that
        its longer side is at most ``max_side``; the last 32 kept."""
        key = (str(media), t)
        cached = self._frame_cache.get(key)
        if cached is not None:
            return cached
        import tempfile

        from framewright_tpu_torch.errors import FramewrightError
        from framewright_tpu_torch.io.png_seq import save_frame
        from framewright_tpu_torch.io.video import open_reader

        try:
            frame = None
            with open_reader(media) as r:
                for i, f in enumerate(r):
                    if i == t:
                        frame = f
                        break
            if frame is None:
                return None
            step = max(1, (max(frame.shape[:2]) + max_side - 1) // max_side)
            with tempfile.TemporaryDirectory() as td:
                p = Path(td) / "f.png"
                save_frame(p, frame[::step, ::step])
                data = p.read_bytes()
        except (OSError, ValueError, FramewrightError) as e:
            logger.warning("frame read failed for %s: %s", media, e)
            return None
        if len(self._frame_cache) > 32:
            self._frame_cache.pop(next(iter(self._frame_cache)))
        self._frame_cache[key] = data
        return data

    def _preview_for(self, source: str):
        """One PreviewServer (cache and render queue) a source file."""
        if source not in self._previews:
            from framewright_tpu_torch.preview import PreviewServer

            ps = PreviewServer(Path(source), Path(self.store.db_path).parent / "previews"
                               / Path(source).stem, device=self.device)
            ps.start()
            self._previews[source] = ps
        return self._previews[source]

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("api: " + fmt, *args)

            def _send(self, code: int, payload, content_type="application/json"):
                body = payload if isinstance(payload, (bytes, str)) else json.dumps(payload)
                if isinstance(body, str):
                    body = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _check_rate(self) -> bool:
                if not server.limiter.allow():
                    self._send(429, {"error": "rate limited"})
                    return False
                return True

            def _read_json(self):
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0 or length > 1_000_000:
                    return None
                try:
                    return json.loads(self.rfile.read(length))
                except json.JSONDecodeError:
                    return None

            def do_GET(self):
                if not self._check_rate():
                    return
                path = self.path.rstrip("/") or "/"
                if path == "/":
                    return self._send(200, _DASHBOARD_HTML, "text/html")
                if path == "/api/health":
                    return self._send(200, {"status": "ok"})
                if path == "/api/hardware":
                    from framewright_tpu_torch.hw import check_hardware

                    return self._send(200, check_hardware())
                if path == "/api/presets":
                    from framewright_tpu_torch.config import PRESETS

                    return self._send(200, {k: v.get("description", "")
                                            for k, v in PRESETS.items()})
                if path == "/api/models":
                    from framewright_tpu_torch.models.registry import MODEL_GUIDE, MODEL_SPECS

                    return self._send(200, {k: {"scale": s.scale, "family": s.family,
                                                "guide": MODEL_GUIDE.get(k, "")}
                                            for k, s in MODEL_SPECS.items()})
                if path == "/api/recipes":
                    from framewright_tpu_torch.recipes import RECIPES

                    return self._send(200, {k: r.description for k, r in RECIPES.items()})
                if path == "/api/config_schema":
                    from framewright_tpu_torch.config import config_schema

                    return self._send(200, config_schema())
                if path == "/api/jobs":
                    return self._send(200, [_job_dict(j) for j in server.store.list_jobs()])
                if path == "/api/events":
                    return self._sse_events()
                if path.startswith("/api/jobs/") and path.endswith("/log"):
                    jid = path.split("/")[-2]
                    lines = server.queue.job_log(jid)
                    if lines is None:
                        if server.store.get_job(jid) is None:
                            return self._send(404, {"error": "not found"})
                        lines = []
                    return self._send(200, {"job_id": jid, "lines": list(lines)})
                if path.startswith("/api/jobs/"):
                    job = server.store.get_job(path.split("/")[-1])
                    if job is None:
                        return self._send(404, {"error": "not found"})
                    return self._send(200, _job_dict(job))
                if path.startswith("/api/preview/"):
                    tid = path.split("/")[-1]
                    for src, ps in server._previews.items():
                        task = ps.queue.get_task(tid)
                        if task is not None:
                            return self._send(200, _task_dict(task, src))
                    return self._send(404, {"error": "not found"})
                if path == "/api/preview-status":
                    return self._send(200, {src: ps.status()
                                            for src, ps in server._previews.items()})
                if path.startswith("/api/frame"):
                    return self._frame_endpoint()
                self._send(404, {"error": "unknown endpoint"})

            def _frame_endpoint(self):
                """``/api/frame?source=<registered source>&t=<i>[&task=<preview
                task>]`` or ``?job=<id>&t=<i>``: frame t of the source, of a
                preview's output, or of a completed job's output. Only
                sources registered by a job or a preview are read."""
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                source = (q.get("source") or [""])[0]
                tid = (q.get("task") or [None])[0]
                jid = (q.get("job") or [None])[0]
                # the reader decodes from the start in the handler's thread:
                # keep the index small
                try:
                    t = max(0, min(int((q.get("t") or ["0"])[0]), 2000))
                except ValueError:
                    return self._send(400, {"error": "bad t"})
                if jid is not None:
                    job = server.store.get_job(jid)
                    if job is None or job.state != "completed" or not job.output:
                        return self._send(404, {"error": "no output yet"})
                    media = Path(job.output)
                else:
                    known = set(server._previews) | {j.source for j in server.store.list_jobs()}
                    if source not in known:
                        return self._send(403, {"error": "unknown source"})
                    media = Path(source)
                    if tid is not None:
                        ps = server._previews.get(source)
                        task = ps.queue.get_task(tid) if ps is not None else None
                        if task is None or task.output is None:
                            return self._send(404, {"error": "no output yet"})
                        media = Path(task.output)
                        t = max(0, t - task.start)
                        if task.n_frames:
                            t = min(t, max(0, task.n_frames - 1))
                png = server._read_frame_png(media, t)
                if png is None:
                    return self._send(404, {"error": "frame unavailable"})
                return self._send(200, png, "image/png")

            def do_POST(self):
                if not self._check_rate():
                    return
                from framewright_tpu_torch.errors import FramewrightError

                path = self.path.rstrip("/")
                body = self._read_json()
                if body is None:
                    return self._send(400, {"error": "bad json"})
                if path == "/api/jobs":
                    source = body.get("source", "")
                    if not source:
                        return self._send(400, {"error": "source required"})
                    try:
                        cfg = server.job_config(body.get("config", {}))
                    except FramewrightError as exc:
                        return self._send(400, {"error": str(exc)})
                    jid = server.queue.submit(source, body.get("output", ""), cfg)
                    server._wake.set()
                    return self._send(201, {"job_id": jid})
                if path == "/api/preview":
                    source = body.get("source", "")
                    if not source or not Path(source).exists():
                        return self._send(400, {"error": "source required"})
                    try:
                        cfg = server.job_config(body.get("config", {}))
                    except FramewrightError as exc:
                        return self._send(400, {"error": str(exc)})
                    task = server._preview_for(source).render_segment(
                        int(body.get("start", 0)), int(body.get("n_frames", 48)), cfg,
                        int(body.get("priority", 5)))
                    return self._send(202, _task_dict(task, source))
                if path in ("/api/analyze", "/api/recommend"):
                    try:
                        return self._send(200, self._analysis(body.get("source", ""),
                                                              path == "/api/recommend"))
                    except Exception as exc:  # noqa: BLE001 - reported to the client
                        return self._send(400, {"error": str(exc)})
                self._send(404, {"error": "unknown endpoint"})

            @staticmethod
            def _analysis(source: str, recommend: bool) -> dict:
                """The content analysis; with ``recommend`` also the preset
                the selector picks, its overrides and the config."""
                from framewright_tpu_torch.io.video import open_reader, probe
                from framewright_tpu_torch.processors.analysis import ContentAnalyzer

                meta = probe(source)
                with open_reader(source) as r:
                    rep = ContentAnalyzer().analyze(iter(r), height=meta.height)
                if not recommend:
                    return rep.to_dict()
                from framewright_tpu_torch.presets import PresetRegistry, SmartPresetSelector

                preset, overrides, cfg = SmartPresetSelector(PresetRegistry()).select_with_info(
                    rep, meta.nb_frames)
                return {"analysis": rep.to_dict(), "preset": preset, "overrides": overrides,
                        "config": cfg.to_dict()}

            def do_DELETE(self):
                if not self._check_rate():
                    return
                path = self.path.rstrip("/")
                if path.startswith("/api/jobs/"):
                    jid = path.split("/")[-1]
                    if server.store.get_job(jid) is None:
                        return self._send(404, {"error": "not found"})
                    server.store.set_state(jid, "cancelled")
                    return self._send(200, {"job_id": jid, "state": "cancelled"})
                self._send(404, {"error": "unknown endpoint"})

            def _sse_events(self):
                """Server-sent events: the job list each time it changes
                (read every 0.5 s; a heartbeat after 30 reads without a
                change), until the client leaves or the server stops. One
                handler thread a client."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "keep-alive")
                self.end_headers()
                last, beats = None, 0
                try:
                    while not server._stop.is_set():
                        payload = json.dumps([_job_dict(j) for j in server.store.list_jobs()])
                        if payload != last or beats >= 30:
                            self.wfile.write(f"data: {payload}\n\n".encode())
                            self.wfile.flush()
                            last, beats = payload, 0
                        else:
                            beats += 1
                        server._stop.wait(0.5)
                except OSError:
                    pass                 # the client went away

        return Handler

    def start(self, process_jobs: bool = True) -> None:
        """Serve on a thread (``port`` 0: a free port, then ``self.port``);
        with ``process_jobs`` a worker thread restores the queued jobs."""
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_port
        threading.Thread(target=self._httpd.serve_forever, daemon=True, name="fw-api").start()
        if process_jobs:
            self._worker = threading.Thread(target=self._drain_loop, daemon=True,
                                            name="fw-api-worker")
            self._worker.start()
        logger.info("API server on http://%s:%d (device %s)", self.host, self.port,
                    self.device)

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            if self.queue.process_next() is None:
                self._wake.wait(1.0)
                self._wake.clear()

    def stop(self) -> None:
        """Stop serving, let a running job end, stop the previews and close
        the store."""
        self._stop.set()
        self._wake.set()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        for ps in self._previews.values():
            ps.stop()
        self.store.close()
