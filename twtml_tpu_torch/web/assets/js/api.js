// Browser API client (reference: web/src/main/assets/js/api.js — same
// responsibilities, rebuilt on native WebSocket/fetch instead of
// jquery-atmosphere): websocket with 5s auto-reconnect, HTTP fallbacks for
// posting, jsonClass-discriminated payload builders, and a simple event bus.
(function (global) {
  "use strict";

  const api = {
    ws: null,
    listeners: [],
    reconnectDelayMs: 5000,
    _wantOpen: false,

    bind(fn) { this.listeners.push(fn); },

    _dispatch(json) {
      for (const fn of this.listeners) {
        try { fn(json); } catch (e) { console.error(e); }
      }
    },

    _wsUrl() {
      const proto = location.protocol === "https:" ? "wss:" : "ws:";
      return proto + "//" + location.host + "/api";
    },

    websocketOn() {
      this._wantOpen = true;
      const sock = new WebSocket(this._wsUrl());
      this.ws = sock;
      sock.onmessage = (ev) => {
        try { this._dispatch(JSON.parse(ev.data)); }
        catch (e) { console.error("bad frame", ev.data); }
      };
      sock.onopen = () => this._dispatch({ jsonClass: "_Socket", open: true });
      sock.onclose = () => {
        this._dispatch({ jsonClass: "_Socket", open: false });
        if (this._wantOpen) {
          setTimeout(() => this.websocketOn(), this.reconnectDelayMs);
        }
      };
    },

    websocketOff() {
      this._wantOpen = false;
      if (this.ws) this.ws.close();
    },

    _wsReady() {
      return this.ws && this.ws.readyState === WebSocket.OPEN;
    },

    // POST via websocket when live, HTTP otherwise (reference api.js:65-79)
    post(payload) {
      const text = JSON.stringify(payload);
      if (this._wsReady()) {
        this.ws.send(text);
        return Promise.resolve();
      }
      return fetch("/api", {
        method: "POST",
        headers: { "content-type": "application/json" },
        body: text,
      });
    },

    postConfig(id, host, viz) {
      return this.post({ jsonClass: "Config", id, host, viz });
    },

    postStats(count, batch, mse, realStddev, predStddev) {
      return this.post({ jsonClass: "Stats", count, batch, mse, realStddev, predStddev });
    },

    getConfig() { return fetch("/api/config").then((r) => r.json()); },
    getStats() { return fetch("/api/stats").then((r) => r.json()); },

    guid() {
      return "xxxxxxxx-xxxx-4xxx-yxxx-xxxxxxxxxxxx".replace(/[xy]/g, (c) => {
        const r = (Math.random() * 16) | 0;
        return (c === "x" ? r : (r & 0x3) | 0x8).toString(16);
      });
    },
  };

  global.api = api;
})(window);
