// Built-in live line chart for real vs predicted retweet counts.
// Replaces the reference's external-Lightning iframes (SessionStats.scala:49-52:
// 4 series — real, pred, and their stdev bands, blue/gold) with a
// dependency-free canvas renderer fed by Series messages over the websocket.
(function (global) {
  "use strict";

  const COLORS = {
    real: "rgb(30, 144, 255)",      // SessionStats.scala:16 blue
    pred: "rgb(255, 215, 0)",       // SessionStats.scala:19 gold
    realBand: "rgba(173, 216, 230, 0.5)",
    predBand: "rgba(238, 232, 170, 0.5)",
  };
  const WINDOW = 400; // points kept on screen

  function LiveChart(canvas) {
    this.canvas = canvas;
    this.ctx = canvas.getContext("2d");
    this.real = [];
    this.pred = [];
    this.realStd = [];
    this.predStd = [];
  }

  LiveChart.prototype.push = function (series) {
    const n = Math.min(series.real.length, series.pred.length);
    for (let i = 0; i < n; i++) {
      this.real.push(series.real[i]);
      this.pred.push(series.pred[i]);
      this.realStd.push(series.realStddev);
      this.predStd.push(series.predStddev);
    }
    const drop = this.real.length - WINDOW;
    if (drop > 0) {
      this.real.splice(0, drop);
      this.pred.splice(0, drop);
      this.realStd.splice(0, drop);
      this.predStd.splice(0, drop);
    }
    this.draw();
  };

  LiveChart.prototype.clear = function () {
    this.real = [];
    this.pred = [];
    this.realStd = [];
    this.predStd = [];
    this.draw();
  };

  LiveChart.prototype.draw = function () {
    const ctx = this.ctx;
    const w = (this.canvas.width = this.canvas.clientWidth || 800);
    const h = (this.canvas.height = this.canvas.clientHeight || 360);
    ctx.clearRect(0, 0, w, h);
    const data = this.real.concat(this.pred);
    if (!data.length) {
      ctx.fillStyle = "rgba(128,128,128,0.6)";
      ctx.font = "14px system-ui";
      ctx.fillText("waiting for stream…", 16, 24);
      return;
    }
    let lo = Math.min(...data), hi = Math.max(...data);
    if (hi === lo) { hi = lo + 1; }
    const pad = (hi - lo) * 0.1;
    lo -= pad; hi += pad;
    const sx = (i, len) => (i / Math.max(len - 1, 1)) * (w - 50) + 40;
    const sy = (v) => h - 20 - ((v - lo) / (hi - lo)) * (h - 40);

    // axis labels
    ctx.fillStyle = "rgba(128,128,128,0.8)";
    ctx.font = "11px system-ui";
    ctx.fillText(Math.round(hi), 4, 14);
    ctx.fillText(Math.round(lo), 4, h - 8);

    const drawLine = (values, color, width) => {
      ctx.beginPath();
      ctx.strokeStyle = color;
      ctx.lineWidth = width;
      values.forEach((v, i) => {
        const x = sx(i, values.length), y = sy(v);
        i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
      });
      ctx.stroke();
    };
    drawLine(this.realStd, COLORS.realBand, 1);
    drawLine(this.predStd, COLORS.predBand, 1);
    drawLine(this.real, COLORS.real, 1.6);
    drawLine(this.pred, COLORS.pred, 1.6);

    // legend
    const legend = [
      ["real", COLORS.real], ["predicted", COLORS.pred],
      ["stdev real", COLORS.realBand], ["stdev pred", COLORS.predBand],
    ];
    let x = 50;
    legend.forEach(([label, color]) => {
      ctx.fillStyle = color;
      ctx.fillRect(x, 6, 10, 10);
      ctx.fillStyle = "rgba(128,128,128,0.9)";
      ctx.fillText(label, x + 14, 15);
      x += ctx.measureText(label).width + 40;
    });
  };

  global.LiveChart = LiveChart;
})(window);
