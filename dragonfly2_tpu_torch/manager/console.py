"""Embedded operator console (reference: manager/manager.go:61-62 embeds
the console SPA; manager/router serves it at /).

A single self-contained HTML page driving the REST API with vanilla JS:
sign-in (token kept in localStorage), model list with activate /
deactivate, scheduler liveness, users and personal access tokens.  No
build step, no assets, no external fetches — the whole console is this
string.

Port of ``dragonfly2_tpu/manager/console.py``, verbatim.
"""

CONSOLE_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>dragonfly2-tpu manager</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 14px/1.5 system-ui, sans-serif; margin: 2rem auto; max-width: 72rem; padding: 0 1rem; }
  h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 2rem; }
  table { border-collapse: collapse; width: 100%; margin: .5rem 0; }
  th, td { text-align: left; padding: .3rem .6rem; border-bottom: 1px solid #8884; }
  th { font-weight: 600; }
  button { cursor: pointer; padding: .15rem .6rem; margin-right: .3rem; }
  input { padding: .25rem .4rem; margin-right: .4rem; }
  .pill { padding: .05rem .5rem; border-radius: 999px; font-size: .8rem; }
  .active { background: #16a34a33; } .inactive { background: #8883; }
  .err { color: #dc2626; } .ok { color: #16a34a; }
  #signin, #app { margin-top: 1rem; }
  .muted { opacity: .65; }
  code { font-size: .85em; }
</style>
</head>
<body>
<h1>dragonfly2-tpu manager console</h1>
<div id="signin">
  <input id="u" placeholder="username"><input id="p" type="password" placeholder="password">
  <button onclick="signin()">Sign in</button>
  <span id="oauth-buttons"></span>
  <span id="signin-msg" class="err"></span>
</div>
<div id="app" style="display:none">
  <span class="muted">signed in as <b id="who"></b> (<span id="role"></span>)</span>
  <button onclick="signout()">Sign out</button>

  <h2>Models</h2>
  <table id="models"><thead><tr>
    <th>name</th><th>type</th><th>version</th><th>scheduler</th><th>state</th><th>evaluation</th><th></th>
  </tr></thead><tbody></tbody></table>

  <h2>Schedulers</h2>
  <table id="schedulers"><thead><tr>
    <th>id</th><th>cluster</th><th>address</th><th>state</th>
  </tr></thead><tbody></tbody></table>

  <h2>Scheduler clusters <span class="muted">(live scheduling config)</span></h2>
  <table id="clusters"><thead><tr>
    <th>id</th><th>name</th><th>default</th><th>scheduler config</th><th>client config</th><th></th>
  </tr></thead><tbody></tbody></table>

  <h2>Applications</h2>
  <input id="app-name" placeholder="name"><input id="app-url" placeholder="url">
  <input id="app-prio" placeholder="priority" size="4">
  <button onclick="createApp()">Create</button>
  <table id="applications"><thead><tr>
    <th>name</th><th>url</th><th>priority</th><th>bio</th><th></th>
  </tr></thead><tbody></tbody></table>

  <h2>Jobs <span class="muted">(async group fan-out: preheat / sync_peers)</span></h2>
  <select id="job-type"><option>preheat</option><option>sync_peers</option></select>
  <input id="job-queues" placeholder="scheduler ids (see table above; blank = all active)">
  <input id="job-url" placeholder="url (preheat)">
  <button onclick="createJob()">Create</button>
  <table id="jobs"><thead><tr>
    <th>group</th><th>state</th><th>jobs</th><th>errors</th>
  </tr></thead><tbody></tbody></table>

  <h2>Users <span class="muted">(admin)</span></h2>
  <table id="users"><thead><tr>
    <th>name</th><th>email</th><th>role</th><th>state</th>
  </tr></thead><tbody></tbody></table>

  <h2>Personal access tokens</h2>
  <input id="pat-name" placeholder="token name">
  <select id="pat-role">
    <option>readonly</option><option>peer</option><option>operator</option><option>admin</option>
  </select>
  <button onclick="createPat()">Create</button>
  <div id="pat-new" class="ok"></div>
  <table id="pats"><thead><tr>
    <th>name</th><th>role</th><th>expires</th><th>revoked</th><th></th>
  </tr></thead><tbody></tbody></table>
</div>
<script>
const tok = () => localStorage.getItem("df_token") || "";
async function api(path, opts) {
  opts = opts || {};
  opts.headers = Object.assign(
    tok() ? {"Authorization": "Bearer " + tok()} : {},
    opts.body ? {"Content-Type": "application/json"} : {}, opts.headers || {});
  const r = await fetch("/api/v1" + path, opts);
  if (r.status === 401 && !opts._retried && localStorage.getItem("df_refresh_id")
      && path !== "/oauth:refresh") {
    // Expired session with a refresh grant in hand: renew and retry once.
    if (await oauthRefresh()) return api(path, Object.assign({}, opts, {_retried: true}));
  }
  if (!r.ok) {
    const err = new Error((await r.json()).error || r.status);
    err.status = r.status;
    throw err;
  }
  return r.json();
}
async function signin() {
  try {
    const out = await api("/users:signin", {method: "POST", body: JSON.stringify(
      {name: document.getElementById("u").value, password: document.getElementById("p").value})});
    localStorage.setItem("df_token", out.token);
    localStorage.setItem("df_role", out.role);
    localStorage.setItem("df_user", document.getElementById("u").value);
    boot();
  } catch (e) { document.getElementById("signin-msg").textContent = e.message; }
}
function signout() { localStorage.clear(); location.reload(); }
// -- OAuth sign-in (providers -> authorize redirect -> callback code ->
//    :signin; sessions renew via /oauth:refresh, falling back to the
//    authorize flow when the provider revoked the refresh token). --
async function oauthButtons() {
  try {
    const providers = await api("/oauth:providers");
    document.getElementById("oauth-buttons").innerHTML = providers.map(p =>
      `<button onclick="oauthStart('${esc(p)}')">Sign in with ${esc(p)}</button>`
    ).join("");
  } catch (e) { /* no oauth configured */ }
}
async function oauthStart(name) {
  const cb = location.origin + location.pathname + "?oauth=" + encodeURIComponent(name);
  const out = await api(`/oauth/${name}:authorize-url?redirect_uri=` + encodeURIComponent(cb));
  location.href = out.url;
}
async function oauthCallback() {
  const q = new URLSearchParams(location.search);
  if (!q.get("oauth") || !q.get("code")) return false;
  const name = q.get("oauth");
  const cb = location.origin + location.pathname + "?oauth=" + encodeURIComponent(name);
  const out = await api(`/oauth/${name}:signin`, {method: "POST", body: JSON.stringify(
    {code: q.get("code"), state: q.get("state"), redirect_uri: cb})});
  localStorage.setItem("df_token", out.token);
  localStorage.setItem("df_role", out.role);
  localStorage.setItem("df_user", out.user || name);
  if (out.refresh_id) localStorage.setItem("df_refresh_id", out.refresh_id);
  history.replaceState(null, "", location.pathname);
  return true;
}
async function oauthRefresh() {
  const rid = localStorage.getItem("df_refresh_id");
  if (!rid) return false;
  try {
    const out = await api("/oauth:refresh", {method: "POST",
      body: JSON.stringify({refresh_id: rid})});
    localStorage.setItem("df_token", out.token);
    localStorage.setItem("df_role", out.role);
    localStorage.setItem("df_refresh_id", out.refresh_id);
    return true;
  } catch (e) {
    if (e.status === 403) {
      // Provider revoked the grant: degrade to re-authentication.
      localStorage.removeItem("df_refresh_id");
      localStorage.removeItem("df_token");
    }
    // Network/5xx: keep the handle — the grant is intact server-side.
    return false;
  }
}
function fill(id, rows) {
  document.querySelector("#" + id + " tbody").innerHTML = rows.join("");
}
const esc = s => String(s).replace(/[&<>"]/g, c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
async function refresh() {
  const models = await api("/models");
  fill("models", models.map(m => `<tr><td>${esc(m.name)}</td><td>${esc(m.type)}</td>
    <td>v${m.version}</td><td><code>${esc(m.scheduler_id)}</code></td>
    <td><span class="pill ${m.state}">${m.state}</span></td>
    <td><code>${esc(JSON.stringify(m.evaluation))}</code></td>
    <td><button onclick="act('${m.id}','activate')">activate</button>
        <button onclick="act('${m.id}','deactivate')">deactivate</button></td></tr>`));
  const scheds = await api("/schedulers");
  fill("schedulers", scheds.map(s => `<tr><td><code>${esc(s.id)}</code></td>
    <td>${esc(s.cluster_id)}</td><td>${esc(s.ip)}:${s.port}</td><td>${esc(s.state)}</td></tr>`));
  const clusters = await api("/clusters");
  // ids ride in data attributes, never inline JS strings — even though
  // the store rejects quote-bearing ids, the console must not rely on it.
  fill("clusters", clusters.map(c => `<tr><td><code>${esc(c.id)}</code></td>
    <td>${esc(c.name)}</td><td>${c.is_default}</td>
    <td><code>${esc(JSON.stringify(c.scheduler_cluster_config))}</code></td>
    <td><code>${esc(JSON.stringify(c.client_config))}</code></td>
    <td><button data-id="${esc(c.id)}" onclick="editCluster(this.dataset.id)">edit config</button></td></tr>`));
  const apps = await api("/applications");
  fill("applications", apps.map(a => `<tr><td>${esc(a.name)}</td>
    <td><code>${esc(a.url)}</code></td><td>${a.priority}</td><td>${esc(a.bio)}</td>
    <td><button data-id="${esc(a.id)}" onclick="delApp(this.dataset.id)">delete</button></td></tr>`));
  const jobs = await api("/jobs");
  fill("jobs", jobs.map(g => `<tr><td><code>${esc(g.group_id)}</code></td>
    <td><span class="pill ${g.state === "SUCCESS" ? "active" : "inactive"}">${esc(g.state)}</span></td>
    <td>${g.jobs.map(j => `${esc(j.queue)}:${esc(j.state)}`).join(" ")}</td>
    <td class="err">${g.jobs.map(j => esc(j.error || "")).filter(Boolean).join("; ")}</td></tr>`));
  try {
    const users = await api("/users");
    fill("users", users.map(u => `<tr><td>${esc(u.name)}</td><td>${esc(u.email)}</td>
      <td>${esc(u.role)}</td><td>${esc(u.state)}</td></tr>`));
  } catch (e) { fill("users", [`<tr><td colspan=4 class="muted">${esc(e.message)}</td></tr>`]); }
  try {
    const pats = await api("/pats");
    fill("pats", pats.map(p => `<tr><td>${esc(p.name)}</td><td>${esc(p.role)}</td>
      <td>${new Date(p.expires_at * 1000).toISOString().slice(0,10)}</td>
      <td>${p.revoked}</td>
      <td><button onclick="revoke('${p.id}')">revoke</button></td></tr>`));
  } catch (e) { fill("pats", []); }
}
async function act(id, action) {
  try { await api(`/models/${id}:${action}`, {method: "POST", body: "{}"}); refresh(); }
  catch (e) { alert(e.message); }
}
async function editCluster(id) {
  const cur = (await api("/clusters")).find(c => c.id === id);
  const next = prompt("scheduler_cluster_config JSON (applied live by schedulers):",
                      JSON.stringify(cur.scheduler_cluster_config));
  if (next === null) return;
  try {
    await api(`/clusters/${id}:update`, {method: "POST", body: JSON.stringify(
      {scheduler_cluster_config: JSON.parse(next)})});
    refresh();
  } catch (e) { alert(e.message); }
}
async function createApp() {
  try {
    await api("/applications", {method: "POST", body: JSON.stringify(
      {name: document.getElementById("app-name").value,
       url: document.getElementById("app-url").value,
       priority: parseInt(document.getElementById("app-prio").value || "0")})});
    refresh();
  } catch (e) { alert(e.message); }
}
async function delApp(id) {
  try { await api(`/applications/${id}:delete`, {method: "POST", body: "{}"}); refresh(); }
  catch (e) { alert(e.message); }
}
async function createJob() {
  try {
    // Workers poll "scheduler:<id>" (cli/scheduler wiring) — accept bare
    // scheduler ids and prefix them; blank = every ACTIVE scheduler.
    let ids = document.getElementById("job-queues").value
      .split(",").map(s => s.trim()).filter(Boolean);
    if (!ids.length) {
      ids = (await api("/schedulers"))
        .filter(s => s.state === "active").map(s => s.id);
      if (!ids.length) { alert("no active schedulers"); return; }
    }
    const queues = ids.map(q => q.includes(":") ? q : "scheduler:" + q);
    const type = document.getElementById("job-type").value;
    // The preheat handler's contract (jobs/preheat.py): urls LIST +
    // piece_size; sync_peers takes no args.
    const args = {};
    const url = document.getElementById("job-url").value;
    if (type === "preheat") {
      if (!url) { alert("preheat needs a url"); return; }
      args.urls = [url];
      args.piece_size = 4 * 1024 * 1024;
    }
    await api("/jobs", {method: "POST", body: JSON.stringify(
      {type: type, queues: queues, args: args})});
    refresh();
  } catch (e) { alert(e.message); }
}
async function createPat() {
  try {
    const out = await api("/pats", {method: "POST", body: JSON.stringify(
      {name: document.getElementById("pat-name").value,
       role: document.getElementById("pat-role").value})});
    document.getElementById("pat-new").textContent =
      "token (shown once): " + out.token;
    refresh();
  } catch (e) { alert(e.message); }
}
async function revoke(id) {
  try { await api(`/pats/${id}:revoke`, {method: "POST", body: "{}"}); refresh(); }
  catch (e) { alert(e.message); }
}
async function boot() {
  try {
    if (await oauthCallback()) { /* token stored from the callback */ }
  } catch (e) {
    // Expired state / replayed callback: clean the URL, surface the
    // error, and fall through to the sign-in options.
    history.replaceState(null, "", location.pathname);
    document.getElementById("signin-msg").textContent = e.message;
  }
  if (!tok() && !(await oauthRefresh())) { oauthButtons(); return; }
  if (!tok()) { oauthButtons(); return; }
  document.getElementById("signin").style.display = "none";
  document.getElementById("app").style.display = "block";
  document.getElementById("who").textContent = localStorage.getItem("df_user") || "?";
  document.getElementById("role").textContent = localStorage.getItem("df_role") || "?";
  refresh();
  setInterval(refresh, 10000);
}
boot();
</script>
</body>
</html>
"""
