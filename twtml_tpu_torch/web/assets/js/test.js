// Manual test harness logic (reference: web/src/main/assets/js/test.js).
(function () {
  "use strict";

  let wsOn = false;

  function log(json) {
    const row = document.getElementById("log").insertRow(1);
    row.insertCell().textContent = new Date().toLocaleTimeString();
    row.insertCell().textContent = JSON.stringify(json);
  }

  document.addEventListener("DOMContentLoaded", () => {
    api.bind(log);

    document.getElementById("wsToggle").addEventListener("click", (ev) => {
      wsOn = !wsOn;
      if (wsOn) api.websocketOn(); else api.websocketOff();
      ev.target.textContent = "websocket: " + (wsOn ? "on" : "off");
    });

    document.getElementById("postConfig").addEventListener("click", () => {
      api.postConfig(
        document.getElementById("cfgId").value,
        document.getElementById("cfgHost").value,
        document.getElementById("cfgViz").value.split(",").map((s) => s.trim()),
      );
    });

    document.getElementById("postStats").addEventListener("click", () => {
      api.postStats(
        Number(document.getElementById("stCount").value),
        Number(document.getElementById("stBatch").value),
        Number(document.getElementById("stMse").value),
        Number(document.getElementById("stReal").value),
        Number(document.getElementById("stPred").value),
      );
    });
  });
})();
