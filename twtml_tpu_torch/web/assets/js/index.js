// Dashboard logic (reference: web/src/main/assets/js/index.js — dispatch on
// jsonClass; Config rebuilds the chart iframes, Stats updates the counters).
(function () {
  "use strict";

  const ids = ["count", "batch", "mse", "realStddev", "predStddev"];
  let chart = null;
  let backfilled = false;
  const pendingSeries = [];

  function onConfig(json) {
    for (const id of ids) document.getElementById(id).textContent = "0";
    if (chart) chart.clear();
    document.getElementById("session").textContent = json.id || "—";
    const graphs = document.getElementById("graphs");
    graphs.replaceChildren();
    for (const vizId of json.viz || []) {
      // the reference embeds Lightning charts via pym
      // (js/index.js:35-43: host + "/visualizations/" + id + "/pym")
      const frame = document.createElement("iframe");
      frame.src = json.host + "/visualizations/" + vizId + "/pym";
      frame.title = "viz " + vizId;
      graphs.appendChild(frame);
    }
  }

  function onStats(json) {
    for (const id of ids) {
      document.getElementById(id).textContent = Number(json[id]).toLocaleString();
    }
  }

  function onMetrics(json) {
    // pipeline observability panel (telemetry/metrics.py snapshot)
    const counters = json.counters || {};
    const gauges = json.gauges || {};
    const health = json.health || {};
    const phase = health.phase || "—";
    const badge = document.getElementById("tunnelPhase");
    badge.textContent = phase;
    badge.classList.toggle("healthy", phase === "healthy");
    badge.classList.toggle("degraded", phase === "degraded");
    document.getElementById("rttMs").textContent =
      String(health.rtt_ms || 0);
    document.getElementById("phaseFlips").textContent =
      String(health.transitions || 0);
    document.getElementById("wireMb").textContent =
      (Number(counters["wire.bytes"] || 0) / 1e6).toFixed(1);
    // compressed-wire ratio (--wireCodec): raw/compressed units bytes of
    // the latest packed batch; 1.00 = codec off or shipping raw
    document.getElementById("wireRatio").textContent =
      (Number(gauges["wire.codec_ratio"] || 1)).toFixed(2);
    // pooled wire arena (r17): outstanding leases and cumulative pool
    // recycles (wire.arena_* — features/arena.py)
    document.getElementById("arenaPool").textContent =
      String(gauges["wire.arena_in_use"] || 0) + " · " +
      String(counters["wire.arena_recycled"] || 0);
    document.getElementById("rssMb").textContent =
      String(gauges["host.rss_mb"] || 0);
    // continuous leak-rate gauge (utils/rss.py least-squares slope over
    // publish-tick samples — the soak estimator, live)
    document.getElementById("rssSlope").textContent =
      Number(gauges["host.rss_slope_mb_per_min"] || 0).toFixed(2);
    // ingest event-time lag (streaming/sources.py sampled gauge, ms → s);
    // "—" until a replay/live source records one
    const ingestLag = gauges["ingest.event_time_lag_ms"];
    document.getElementById("ingestLag").textContent =
      ingestLag === undefined ? "—" : (Number(ingestLag) / 1000).toFixed(1);
    document.getElementById("fetchDepth").textContent =
      String(gauges["fetch.queue_depth"] || 0);
    // ingest/state robustness (bounded queue + divergence sentinel)
    // block-parse throughput (ingest.parse_tweets_per_s, tweets/s -> k/s):
    // the bottleneck ladder's parse rung, live
    document.getElementById("parseRate").textContent =
      (Number(gauges["ingest.parse_tweets_per_s"] || 0) / 1000).toFixed(0);
    document.getElementById("queueRows").textContent =
      String(gauges["ingest.queue_rows"] || 0);
    document.getElementById("rowsShed").textContent =
      String(counters["ingest.rows_shed"] || 0);
    const rb = document.getElementById("rollbacks");
    rb.textContent = String(counters["model.rollbacks"] || 0);
    rb.classList.toggle("degraded", (counters["model.rollbacks"] || 0) > 0);
    // durable intake journal: rows re-ingested by replay recovery (the
    // crash-equals-clean counter — nonzero means a recovery replayed
    // instead of counting rows lost)
    document.getElementById("journalReplayed").textContent =
      String(counters["journal.replayed_rows"] || 0);
    // derived latency quantiles (Histogram.snapshot p95, seconds → ms)
    const hist = (json.histograms || {})["fetch.latency_s"] || {};
    document.getElementById("fetchP95").textContent =
      (Number(hist.p95 || 0) * 1000).toFixed(1);
  }

  function onHosts(json) {
    // per-host lockstep tiles (telemetry/sideband.py): one tile per host,
    // the straggler attributor's pick highlighted with its ladder stage
    const straggler = document.getElementById("straggler");
    const gating = Number(json.straggler) >= 0;
    straggler.textContent = gating
      ? "host " + json.straggler + (json.stage ? " · " + json.stage : "")
      : "—";
    straggler.classList.toggle("degraded", gating);
    document.getElementById("tickSkew").textContent =
      String(json.skewMs || 0);
    // elastic membership (streaming/membership.py): epoch + live host
    // count + the current lead (moves at a won election), cumulative
    // churn; "—" when the run is not elastic
    const elastic = Number(json.epoch) >= 0;
    document.getElementById("elasticEpoch").textContent = elastic
      ? json.epoch + " · " + (json.liveHosts || 0) + " host" +
        ((json.liveHosts || 0) === 1 ? "" : "s") +
        (Number(json.leadUid) >= 0 ? " · lead " + json.leadUid : "")
      : "—";
    document.getElementById("elasticChurn").textContent = elastic
      ? (json.departed || 0) + " / " + (json.rejoined || 0)
      : "—";
    const panel = document.getElementById("hostsPanel");
    panel.replaceChildren();
    for (const h of json.hosts || []) {
      const tile = document.createElement("div");
      tile.className = "stat";
      const isGating = gating && h.host === json.straggler;
      if (isGating) tile.classList.add("gating");
      const label = document.createElement("div");
      label.className = "label";
      label.textContent = "host " + h.host + (isGating ? " · gating" : "");
      const value = document.createElement("div");
      value.className = "value";
      value.textContent = Number(h.tick_prep_ms || 0).toFixed(0) + " ms";
      tile.appendChild(label);
      tile.appendChild(value);
      panel.appendChild(tile);
    }
  }

  function onTenants(json) {
    // per-tenant model-plane tiles (telemetry/tenants.py): one tile per
    // tenant with its last-batch rows + mse; the gating tenant (most rows
    // this tick — where the shared row bucket binds first) highlighted
    var tenants = json.tenants || [];
    document.getElementById("tenantsActive").textContent =
      tenants.length ? String(json.active || 0) + " / " + tenants.length : "—";
    const panel = document.getElementById("tenantsPanel");
    panel.replaceChildren();
    for (const t of tenants) {
      const tile = document.createElement("div");
      tile.className = "stat";
      const isGating = Number(json.gating) >= 0 && t.tenant === json.gating;
      if (isGating) tile.classList.add("gating");
      const label = document.createElement("div");
      label.className = "label";
      label.textContent = "tenant " + t.tenant + (isGating ? " · gating" : "");
      const value = document.createElement("div");
      value.className = "value";
      value.textContent =
        Number(t.rows || 0).toLocaleString() +
        (t.mse >= 0 ? " · mse " + Math.round(Number(t.mse)) : "");
      tile.appendChild(label);
      tile.appendChild(value);
      panel.appendChild(tile);
    }
  }

  function onServing(json) {
    // serving-plane tiles (serving/plane.py stats view): QPS + latency
    // quantiles, the active snapshot (step + checkpoint quality level),
    // error count, and per-tenant served-row tiles on the tenant plane
    const hasSnapshot = Number(json.snapshotStep) >= 0;
    document.getElementById("serveQps").textContent = hasSnapshot
      ? Number(json.qps || 0).toFixed(1)
      : "—";
    document.getElementById("serveRows").textContent =
      Number(json.rowsPerSec || 0).toLocaleString();
    document.getElementById("serveP50").textContent =
      Number(json.p50Ms || 0).toFixed(1);
    document.getElementById("serveP99").textContent =
      Number(json.p99Ms || 0).toFixed(1);
    document.getElementById("serveSnapshot").textContent = hasSnapshot
      ? "ckpt-" + json.snapshotStep
      : "—";
    // serving staleness (ISSUE 16): seconds since the active snapshot was
    // installed; the stale badge mirrors the plane's warn-only SLO episode
    const age = Number(json.snapshotAgeS);
    const ageEl = document.getElementById("serveAge");
    ageEl.textContent = hasSnapshot && age >= 0 ? age.toFixed(0) : "—";
    ageEl.classList.toggle("stale", json.level === "stale");
    const levelEl = document.getElementById("serveLevel");
    const level = json.level || "—";
    levelEl.textContent = level;
    levelEl.classList.toggle("ok", level === "ok");
    levelEl.classList.toggle("warn", level === "warn");
    const errs = Number(json.errors || 0);
    const errEl = document.getElementById("serveErrors");
    errEl.textContent = String(errs);
    errEl.classList.toggle("degraded", errs > 0);
    const panel = document.getElementById("servingTenantsPanel");
    panel.replaceChildren();
    for (const t of json.tenants || []) {
      const tile = document.createElement("div");
      tile.className = "stat";
      const label = document.createElement("div");
      label.className = "label";
      label.textContent = "tenant " + t.tenant;
      const value = document.createElement("div");
      value.className = "value";
      value.textContent = Number(t.rows || 0).toLocaleString() + " rows";
      tile.appendChild(label);
      tile.appendChild(value);
      panel.appendChild(tile);
    }
  }

  function onFleet(json) {
    // read-fleet tiles (serving/fleet.py stats view via apps/router.py):
    // policy + router retry/ejection story, the fleet-wide champion on the
    // champion/challenger plane, and one tile per replica (qps + forward
    // p99; an ejected replica is highlighted until its probe recovers it)
    const replicas = json.replicas || [];
    document.getElementById("fleetPolicy").textContent =
      replicas.length ? (json.policy || "—") : "—";
    document.getElementById("fleetRequests").textContent =
      Number(json.requests || 0).toLocaleString();
    const retries = Number(json.retries || 0);
    const retriesEl = document.getElementById("fleetRetries");
    retriesEl.textContent = String(retries);
    retriesEl.classList.toggle("degraded", retries > 0);
    const ejections = Number(json.ejections || 0);
    const ejectionsEl = document.getElementById("fleetEjections");
    ejectionsEl.textContent = String(ejections);
    ejectionsEl.classList.toggle("degraded", ejections > 0);
    document.getElementById("fleetChampion").textContent =
      Number(json.champion) >= 0 ? "tenant " + json.champion : "—";
    const panel = document.getElementById("fleetPanel");
    panel.replaceChildren();
    for (const r of replicas) {
      const tile = document.createElement("div");
      tile.className = "stat";
      if (!r.healthy) tile.classList.add("ejected");
      const label = document.createElement("div");
      label.className = "label";
      label.textContent =
        "replica " + r.replica + (r.healthy ? "" : " · ejected");
      const value = document.createElement("div");
      value.className = "value";
      value.textContent =
        Number(r.qps || 0).toFixed(1) + " qps · p99 " +
        Number(r.p99Ms || 0).toFixed(0) + " ms";
      tile.appendChild(label);
      tile.appendChild(value);
      panel.appendChild(tile);
    }
  }

  function drawLossSpark(values) {
    // rolling per-batch mse sparkline (ModelHealth.mse window)
    const canvas = document.getElementById("lossSpark");
    const ctx = canvas.getContext("2d");
    const w = (canvas.width = canvas.clientWidth || 800);
    const h = (canvas.height = canvas.clientHeight || 60);
    ctx.clearRect(0, 0, w, h);
    if (!values.length) {
      ctx.fillStyle = "rgba(128,128,128,0.6)";
      ctx.font = "11px system-ui";
      ctx.fillText("loss sparkline — waiting for model telemetry…", 8, 14);
      return;
    }
    let lo = Math.min(...values), hi = Math.max(...values);
    if (hi === lo) { hi = lo + 1; }
    ctx.beginPath();
    ctx.strokeStyle = "rgb(29, 78, 216)";
    ctx.lineWidth = 1.4;
    values.forEach((v, i) => {
      const x = (i / Math.max(values.length - 1, 1)) * (w - 10) + 5;
      const y = h - 6 - ((v - lo) / (hi - lo)) * (h - 12);
      i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    });
    ctx.stroke();
    ctx.fillStyle = "rgba(128,128,128,0.8)";
    ctx.font = "10px system-ui";
    ctx.fillText("mse " + Math.round(values[values.length - 1]), 6, 12);
  }

  function onModelHealth(json) {
    // model & data quality tiles (telemetry/modelwatch.py): graduated
    // health badge, drift z / loss-trend numbers, norm gauges, per-tenant
    // drift tiles on the multi-tenant plane, and the loss sparkline
    const level = json.level || "—";
    const badge = document.getElementById("modelLevel");
    badge.textContent = level;
    badge.classList.toggle("ok", level === "ok");
    badge.classList.toggle("warn", level === "warn");
    badge.classList.toggle("alert", level === "alert");
    document.getElementById("driftScore").textContent =
      Number(json.driftScore || 0).toFixed(1);
    const trend = Number(json.lossTrend || 0);
    document.getElementById("lossTrend").textContent =
      (trend >= 0 ? "+" : "") + (trend * 100).toFixed(0) + "%";
    document.getElementById("weightNorm").textContent =
      Number(json.weightNorm || 0).toFixed(1);
    document.getElementById("updateNorm").textContent =
      Number(json.updateNorm || 0).toFixed(2);
    document.getElementById("driftEpisodes").textContent =
      String(json.episodes || 0);
    const panel = document.getElementById("modelTenantsPanel");
    panel.replaceChildren();
    for (const t of json.tenants || []) {
      const tile = document.createElement("div");
      tile.className = "stat";
      const alerting = t.level === "alert" || t.level === "warn";
      if (alerting) tile.classList.add("alerting");
      const label = document.createElement("div");
      label.className = "label";
      label.textContent = "tenant " + t.tenant;
      const value = document.createElement("div");
      value.className = "value";
      value.textContent =
        (t.level || "ok") + " · z " + Number(t.drift || 0).toFixed(1);
      tile.appendChild(label);
      tile.appendChild(value);
      panel.appendChild(tile);
    }
    drawLossSpark(json.mse || []);
  }

  function drawFreshSpark(values) {
    // rolling watermark-lag sparkline (Freshness.watermark window)
    const canvas = document.getElementById("freshSpark");
    const ctx = canvas.getContext("2d");
    const w = (canvas.width = canvas.clientWidth || 800);
    const h = (canvas.height = canvas.clientHeight || 60);
    ctx.clearRect(0, 0, w, h);
    if (!values.length) {
      ctx.fillStyle = "rgba(128,128,128,0.6)";
      ctx.font = "11px system-ui";
      ctx.fillText("watermark sparkline — waiting for freshness telemetry…", 8, 14);
      return;
    }
    let lo = Math.min(...values), hi = Math.max(...values);
    if (hi === lo) { hi = lo + 1; }
    ctx.beginPath();
    ctx.strokeStyle = "rgb(21, 128, 61)";
    ctx.lineWidth = 1.4;
    values.forEach((v, i) => {
      const x = (i / Math.max(values.length - 1, 1)) * (w - 10) + 5;
      const y = h - 6 - ((v - lo) / (hi - lo)) * (h - 12);
      i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    });
    ctx.stroke();
    ctx.fillStyle = "rgba(128,128,128,0.8)";
    ctx.font = "10px system-ui";
    ctx.fillText(
      "watermark lag " + Math.round(values[values.length - 1]) + " ms", 6, 12
    );
  }

  function onFreshness(json) {
    // end-to-end freshness tiles (telemetry/freshness.py view): event-time
    // lag percentiles, event→publish lag, the low-watermark lag + its
    // sparkline, the dominant critical-path edge, and the SLO breach count
    const live = Number(json.batches) > 0;
    const ms = (v) => (live && Number(v) >= 0 ? Number(v).toFixed(0) : "—");
    document.getElementById("freshP50").textContent = ms(json.eventLagP50Ms);
    document.getElementById("freshP95").textContent = ms(json.eventLagP95Ms);
    document.getElementById("freshP99").textContent = ms(json.eventLagP99Ms);
    document.getElementById("freshPublish").textContent =
      ms(json.publishLagP95Ms);
    document.getElementById("freshWatermark").textContent =
      ms(json.watermarkLagMs);
    document.getElementById("freshCritical").textContent =
      json.critical || "—";
    const breaches = Number(json.breaches || 0);
    const breachEl = document.getElementById("freshBreaches");
    breachEl.textContent = String(breaches);
    breachEl.classList.toggle("degraded", breaches > 0);
    drawFreshSpark(json.watermark || []);
  }

  function drawHistorySpark(canvasId, values, label, unit, color) {
    // one historian sparkline tile (History.rss / .rtt / .stageMs windows)
    const canvas = document.getElementById(canvasId);
    const ctx = canvas.getContext("2d");
    const w = (canvas.width = canvas.clientWidth || 800);
    const h = (canvas.height = canvas.clientHeight || 44);
    ctx.clearRect(0, 0, w, h);
    if (!values.length) {
      ctx.fillStyle = "rgba(128,128,128,0.6)";
      ctx.font = "11px system-ui";
      ctx.fillText(label + " — waiting for historian samples…", 8, 14);
      return;
    }
    let lo = Math.min(...values), hi = Math.max(...values);
    if (hi === lo) { hi = lo + 1; }
    ctx.beginPath();
    ctx.strokeStyle = color;
    ctx.lineWidth = 1.4;
    values.forEach((v, i) => {
      const x = (i / Math.max(values.length - 1, 1)) * (w - 10) + 5;
      const y = h - 6 - ((v - lo) / (hi - lo)) * (h - 12);
      i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    });
    ctx.stroke();
    ctx.fillStyle = "rgba(128,128,128,0.8)";
    ctx.font = "10px system-ui";
    ctx.fillText(
      label + " " + values[values.length - 1].toFixed(1) + " " + unit, 6, 12
    );
  }

  function onHistory(json) {
    // telemetry-historian tiles (telemetry/historian.py view): long-horizon
    // RSS / fetch-RTT / per-tick stage-cost sparklines + the perfGuard
    // regression count, from the durable time-series tail
    const live = Number(json.samples) > 0;
    const num = (v, d) => (live ? Number(v).toFixed(d) : "—");
    document.getElementById("histSamples").textContent =
      live ? String(json.samples) : "—";
    document.getElementById("histPhase").textContent = json.phase || "—";
    document.getElementById("histRss").textContent = num(json.rssMb, 0);
    document.getElementById("histSlope").textContent =
      num(json.rssSlopeMbPerMin, 2);
    document.getElementById("histRtt").textContent = num(json.rttMs, 1);
    document.getElementById("histDisk").textContent = num(json.diskMb, 1);
    const regress = Number(json.regressions || 0);
    const regressEl = document.getElementById("histRegressions");
    regressEl.textContent = String(regress);
    regressEl.classList.toggle("degraded", regress > 0);
    document.getElementById("histPhase").classList.toggle(
      "degraded", json.phase === "degraded"
    );
    drawHistorySpark("histRssSpark", json.rss || [], "host rss", "mb",
                     "rgb(180, 83, 9)");
    drawHistorySpark("histRttSpark", json.rtt || [], "fetch rtt", "ms",
                     "rgb(29, 78, 216)");
    drawHistorySpark("histStageSpark", json.stageMs || [],
                     "stage cost / tick", "ms", "rgb(107, 33, 168)");
  }

  function onMessage(json) {
    switch (json.jsonClass) {
      case "Config": onConfig(json); break;
      case "Stats": onStats(json); break;
      case "Metrics": onMetrics(json); break;
      case "Hosts": onHosts(json); break;
      case "Tenants": onTenants(json); break;
      case "ModelHealth": onModelHealth(json); break;
      case "Serving": onServing(json); break;
      case "Fleet": onFleet(json); break;
      case "Freshness": onFreshness(json); break;
      case "History": onHistory(json); break;
      case "Series":
        // live frames buffer until the history backfill lands (ordering)
        if (!backfilled) pendingSeries.push(json);
        else if (chart) chart.push(json);
        break;
      case "_Socket": {
        const badge = document.getElementById("conn");
        badge.textContent = json.open ? "live" : "offline";
        badge.classList.toggle("live", !!json.open);
        break;
      }
    }
  }

  document.addEventListener("DOMContentLoaded", () => {
    chart = new LiveChart(document.getElementById("livechart"));
    chart.draw();
    api.bind(onMessage);
    api.websocketOn();
    api.getStats().then(onStats).catch(() => {});
    // observability panel backfill (latest Metrics snapshot, if any)
    fetch("/api/metrics").then((r) => r.json()).then(onMetrics).catch(() => {});
    // per-host lockstep view backfill (empty hosts[] on single-host runs)
    fetch("/api/hosts").then((r) => r.json()).then(onHosts).catch(() => {});
    // per-tenant model-plane backfill (empty tenants[] single-tenant)
    fetch("/api/tenants").then((r) => r.json()).then(onTenants).catch(() => {});
    // model-health backfill (level "ok", empty sparkline until telemetry)
    fetch("/api/model").then((r) => r.json()).then(onModelHealth).catch(() => {});
    // serving-plane backfill (snapshotStep -1 until a serve process posts)
    fetch("/api/serving").then((r) => r.json()).then(onServing).catch(() => {});
    // read-fleet backfill (empty replicas[] off a router process)
    fetch("/api/fleet").then((r) => r.json()).then(onFleet).catch(() => {});
    // freshness-plane backfill (batches 0 until a training run publishes)
    fetch("/api/freshness").then((r) => r.json()).then(onFreshness).catch(() => {});
    // historian backfill (samples 0 until a --history run publishes)
    fetch("/api/history").then((r) => r.json()).then(onHistory).catch(() => {});
    // backfill the chart from the server's rolling series window, then
    // apply any live frames that arrived while the fetch was in flight
    const flush = () => {
      backfilled = true;
      for (const s of pendingSeries.splice(0)) chart.push(s);
    };
    fetch("/api/series").then((r) => r.json()).then((items) => {
      for (const s of items) chart.push(s);
      flush();
    }).catch(flush);
  });
})();
