/* brax_tpu trajectory viewer — self-contained WebGL renderer.
 *
 * Renders a physics scene JSON (see brax_tpu/io/json.py) and plays back the
 * trajectory with scrubbing, speed control, body selection (GPU picking),
 * per-body live pose readout, visibility toggles, debug axes, a contact
 * debug overlay, and PNG capture.
 *
 * Role parity with the reference's js/ viewer (system/animator/selector/
 * viewer, /root/reference/js/*.js) but written from scratch with NO external
 * dependencies: no three.js, no CDN — the generated HTML page works fully
 * offline (the reference page cannot).
 *
 * Expects global `system` (the scene JSON object, injected by io/html.py).
 */
'use strict';

/* ------------------------------ math ------------------------------ */

function mat4Identity() {
  return new Float32Array([1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,0,1]);
}

function mat4Mul(a, b) {  // column-major, returns a*b
  const o = new Float32Array(16);
  for (let c = 0; c < 4; c++) {
    for (let r = 0; r < 4; r++) {
      o[c*4+r] = a[r]*b[c*4] + a[4+r]*b[c*4+1] + a[8+r]*b[c*4+2] + a[12+r]*b[c*4+3];
    }
  }
  return o;
}

function mat4FromQuatPos(q, p) {  // q = [w,x,y,z]
  const [w,x,y,z] = q;
  const xx=x*x, yy=y*y, zz=z*z, xy=x*y, xz=x*z, yz=y*z, wx=w*x, wy=w*y, wz=w*z;
  return new Float32Array([
    1-2*(yy+zz), 2*(xy+wz),   2*(xz-wy),   0,
    2*(xy-wz),   1-2*(xx+zz), 2*(yz+wx),   0,
    2*(xz+wy),   2*(yz-wx),   1-2*(xx+yy), 0,
    p[0], p[1], p[2], 1,
  ]);
}

function quatFromEulerXYZ(rx, ry, rz) {  // intrinsic XYZ, degrees
  const d = Math.PI / 360.0;  // half-angle per degree
  const cx=Math.cos(rx*d), sx=Math.sin(rx*d);
  const cy=Math.cos(ry*d), sy=Math.sin(ry*d);
  const cz=Math.cos(rz*d), sz=Math.sin(rz*d);
  return [
    cx*cy*cz - sx*sy*sz,
    sx*cy*cz + cx*sy*sz,
    cx*sy*cz - sx*cy*sz,
    cx*cy*sz + sx*sy*cz,
  ];
}

function mat4Perspective(fovYDeg, aspect, near, far) {
  const f = 1.0 / Math.tan(fovYDeg * Math.PI / 360.0);
  const o = new Float32Array(16);
  o[0] = f / aspect; o[5] = f;
  o[10] = (far + near) / (near - far); o[11] = -1;
  o[14] = 2 * far * near / (near - far);
  return o;
}

function mat4LookAt(eye, target, up) {
  const zx=eye[0]-target[0], zy=eye[1]-target[1], zz=eye[2]-target[2];
  let zl = Math.hypot(zx,zy,zz) || 1;
  const z = [zx/zl, zy/zl, zz/zl];
  const x0 = up[1]*z[2]-up[2]*z[1], x1 = up[2]*z[0]-up[0]*z[2], x2 = up[0]*z[1]-up[1]*z[0];
  let xl = Math.hypot(x0,x1,x2) || 1;
  const x = [x0/xl, x1/xl, x2/xl];
  const y = [z[1]*x[2]-z[2]*x[1], z[2]*x[0]-z[0]*x[2], z[0]*x[1]-z[1]*x[0]];
  return new Float32Array([
    x[0], y[0], z[0], 0,
    x[1], y[1], z[1], 0,
    x[2], y[2], z[2], 0,
    -(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]),
    -(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]),
    -(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]), 1,
  ]);
}

/* --------------------------- geometry ----------------------------- */
/* Builders return {positions: Float32Array, normals, indices: Uint32Array}
 * in the collider's local frame, z-up (matching the physics convention). */

function geoCapsule(radius, length, radialSeg, capSeg) {
  // also serves spheres: length == 2*radius degenerates the cylinder to 0
  // capsule along local z: cylinder of height (length - 2r) + hemispheres
  const half = Math.max(length / 2 - radius, 0);
  const pos = [], nrm = [], idx = [];
  // rows: top pole..equator at +half, equator..bottom pole at -half
  const rows = [];
  for (let i = 0; i <= capSeg; i++) {             // top hemisphere
    rows.push({phi: (i / capSeg) * Math.PI / 2, zc: half});
  }
  for (let i = 0; i <= capSeg; i++) {             // bottom hemisphere
    rows.push({phi: Math.PI / 2 + (i / capSeg) * Math.PI / 2, zc: -half});
  }
  rows.forEach((row) => {
    for (let ix = 0; ix <= radialSeg; ix++) {
      const theta = (ix / radialSeg) * 2 * Math.PI;
      const sp = Math.sin(row.phi), cp = Math.cos(row.phi);
      const nx = sp * Math.cos(theta), ny = sp * Math.sin(theta), nz = cp;
      pos.push(radius*nx, radius*ny, radius*nz + row.zc);
      nrm.push(nx, ny, nz);
    }
  });
  const nrows = rows.length;
  for (let iy = 0; iy < nrows - 1; iy++) {
    for (let ix = 0; ix < radialSeg; ix++) {
      const a = iy*(radialSeg+1) + ix, b = a + radialSeg + 1;
      idx.push(a, b, a+1, a+1, b, b+1);
    }
  }
  return {positions: new Float32Array(pos), normals: new Float32Array(nrm),
          indices: new Uint32Array(idx)};
}

function geoBox(hx, hy, hz) {
  const faces = [
    {n: [1,0,0],  u: [0,1,0], v: [0,0,1], d: hx},
    {n: [-1,0,0], u: [0,0,1], v: [0,1,0], d: hx},
    {n: [0,1,0],  u: [0,0,1], v: [1,0,0], d: hy},
    {n: [0,-1,0], u: [1,0,0], v: [0,0,1], d: hy},
    {n: [0,0,1],  u: [1,0,0], v: [0,1,0], d: hz},
    {n: [0,0,-1], u: [0,1,0], v: [1,0,0], d: hz},
  ];
  const pos = [], nrm = [], idx = [];
  faces.forEach((f) => {
    const base = pos.length / 3;
    // p = n*d + su*u*h_u + sv*v*h_v with h_u/h_v the half-sizes along u/v
    const hu = f.u[0]*hx + f.u[1]*hy + f.u[2]*hz;
    const hv = f.v[0]*hx + f.v[1]*hy + f.v[2]*hz;
    for (const su of [-1, 1]) {
      for (const sv of [-1, 1]) {
        pos.push(f.n[0]*f.d + su*f.u[0]*hu + sv*f.v[0]*hv,
                 f.n[1]*f.d + su*f.u[1]*hu + sv*f.v[1]*hv,
                 f.n[2]*f.d + su*f.u[2]*hu + sv*f.v[2]*hv);
        nrm.push(f.n[0], f.n[1], f.n[2]);
      }
    }
    idx.push(base, base+2, base+1, base+1, base+2, base+3);  // CCW out
  });
  return {positions: new Float32Array(pos), normals: new Float32Array(nrm),
          indices: new Uint32Array(idx)};
}

function geoGrid(size, seg, heightData) {
  // z-up grid centered... heightmaps anchor at corner (cell (0,0) at origin)
  const pos = [], nrm = [], idx = [];
  const n = seg + 1;
  for (let j = 0; j < n; j++) {
    for (let i = 0; i < n; i++) {
      const x = (i / seg) * size, y = (j / seg) * size;
      // physics layout: data.reshape(n, n)[x_idx, y_idx] (sim/builder.py:626)
      const z = heightData ? (heightData[i * n + j] || 0) : 0;
      pos.push(heightData ? x : x - size/2, heightData ? y : y - size/2, z);
      nrm.push(0, 0, 1);
    }
  }
  for (let j = 0; j < seg; j++) {
    for (let i = 0; i < seg; i++) {
      const a = j*n+i, b = a+1, c = a+n, d = c+1;
      idx.push(a, b, c, b, d, c);
    }
  }
  const g = {positions: new Float32Array(pos), normals: new Float32Array(nrm),
             indices: new Uint32Array(idx)};
  if (heightData) computeNormals(g);
  return g;
}

function geoTrimesh(vertices, faces, scale) {
  const s = scale || 1.0;
  const pos = new Float32Array(vertices.length * 3);
  for (let i = 0; i < vertices.length; i++) {
    pos[3*i] = vertices[i][0]*s; pos[3*i+1] = vertices[i][1]*s; pos[3*i+2] = vertices[i][2]*s;
  }
  const g = {positions: pos, normals: new Float32Array(pos.length),
             indices: new Uint32Array(faces.flat ? faces.flat() : faces)};
  computeNormals(g);
  return g;
}

function computeNormals(g) {
  const n = new Float32Array(g.positions.length);
  const p = g.positions, ix = g.indices;
  for (let t = 0; t < ix.length; t += 3) {
    const a = ix[t]*3, b = ix[t+1]*3, c = ix[t+2]*3;
    const ux = p[b]-p[a], uy = p[b+1]-p[a+1], uz = p[b+2]-p[a+2];
    const vx = p[c]-p[a], vy = p[c+1]-p[a+1], vz = p[c+2]-p[a+2];
    const nx = uy*vz-uz*vy, ny = uz*vx-ux*vz, nz = ux*vy-uy*vx;
    for (const o of [a, b, c]) { n[o] += nx; n[o+1] += ny; n[o+2] += nz; }
  }
  for (let i = 0; i < n.length; i += 3) {
    const l = Math.hypot(n[i], n[i+1], n[i+2]) || 1;
    n[i] /= l; n[i+1] /= l; n[i+2] /= l;
  }
  g.normals = n;
}

/* --------------------------- renderer ----------------------------- */

const VERT_SRC = `#version 300 es
layout(location=0) in vec3 a_pos;
layout(location=1) in vec3 a_nrm;
uniform mat4 u_proj, u_view, u_model;
out vec3 v_nrm;
out vec3 v_wpos;
void main() {
  vec4 w = u_model * vec4(a_pos, 1.0);
  v_wpos = w.xyz;
  v_nrm = mat3(u_model) * a_nrm;
  gl_Position = u_proj * u_view * w;
}`;

const FRAG_SRC = `#version 300 es
precision highp float;
in vec3 v_nrm;
in vec3 v_wpos;
uniform vec3 u_color;
uniform vec3 u_eye;
uniform float u_flat;     // 1.0 = unlit (pick pass / contact dots)
out vec4 frag;
void main() {
  if (u_flat > 0.5) { frag = vec4(u_color, 1.0); return; }
  vec3 n = normalize(v_nrm);
  if (!gl_FrontFacing) n = -n;
  vec3 lightDir = normalize(vec3(0.35, 0.5, 0.8));
  float diff = max(dot(n, lightDir), 0.0);
  float hemi = 0.5 + 0.5 * n.z;                    // sky/ground ambient
  vec3 viewDir = normalize(u_eye - v_wpos);
  vec3 h = normalize(lightDir + viewDir);
  float spec = pow(max(dot(n, h), 0.0), 32.0) * 0.25;
  vec3 c = u_color * (0.35 * hemi + 0.75 * diff) + vec3(spec);
  frag = vec4(pow(c, vec3(1.0/2.2)), 1.0);
}`;

class Renderer {
  constructor(canvas) {
    this.canvas = canvas;
    const gl = canvas.getContext('webgl2', {preserveDrawingBuffer: true});
    if (!gl) throw new Error('WebGL2 unavailable');
    this.gl = gl;
    this.prog = this._compile(VERT_SRC, FRAG_SRC);
    this.u = {};
    for (const name of ['u_proj','u_view','u_model','u_color','u_eye','u_flat']) {
      this.u[name] = gl.getUniformLocation(this.prog, name);
    }
    // no face culling: mesh colliders come from STL/OBJ files with
    // arbitrary winding, and grounds must render from below too
    gl.enable(gl.DEPTH_TEST);

    // offscreen framebuffer for GPU picking (same size as the canvas, so
    // pick passes never flash on screen)
    this.pickFbo = gl.createFramebuffer();
    gl.bindFramebuffer(gl.FRAMEBUFFER, this.pickFbo);
    const tex = gl.createTexture();
    gl.bindTexture(gl.TEXTURE_2D, tex);
    gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA, canvas.width, canvas.height, 0,
                  gl.RGBA, gl.UNSIGNED_BYTE, null);
    gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.NEAREST);
    gl.framebufferTexture2D(gl.FRAMEBUFFER, gl.COLOR_ATTACHMENT0,
                            gl.TEXTURE_2D, tex, 0);
    const depth = gl.createRenderbuffer();
    gl.bindRenderbuffer(gl.RENDERBUFFER, depth);
    gl.renderbufferStorage(gl.RENDERBUFFER, gl.DEPTH_COMPONENT16,
                           canvas.width, canvas.height);
    gl.framebufferRenderbuffer(gl.FRAMEBUFFER, gl.DEPTH_ATTACHMENT,
                               gl.RENDERBUFFER, depth);
    gl.bindFramebuffer(gl.FRAMEBUFFER, null);
  }

  _compile(vsrc, fsrc) {
    const gl = this.gl;
    const mk = (type, src) => {
      const s = gl.createShader(type);
      gl.shaderSource(s, src); gl.compileShader(s);
      if (!gl.getShaderParameter(s, gl.COMPILE_STATUS)) {
        throw new Error(gl.getShaderInfoLog(s));
      }
      return s;
    };
    const p = gl.createProgram();
    gl.attachShader(p, mk(gl.VERTEX_SHADER, vsrc));
    gl.attachShader(p, mk(gl.FRAGMENT_SHADER, fsrc));
    gl.linkProgram(p);
    if (!gl.getProgramParameter(p, gl.LINK_STATUS)) {
      throw new Error(gl.getProgramInfoLog(p));
    }
    return p;
  }

  upload(geom) {
    const gl = this.gl;
    const vao = gl.createVertexArray();
    gl.bindVertexArray(vao);
    const vb = gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER, vb);
    gl.bufferData(gl.ARRAY_BUFFER, geom.positions, gl.STATIC_DRAW);
    gl.enableVertexAttribArray(0);
    gl.vertexAttribPointer(0, 3, gl.FLOAT, false, 0, 0);
    const nb = gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER, nb);
    gl.bufferData(gl.ARRAY_BUFFER, geom.normals, gl.STATIC_DRAW);
    gl.enableVertexAttribArray(1);
    gl.vertexAttribPointer(1, 3, gl.FLOAT, false, 0, 0);
    const ib = gl.createBuffer();
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ib);
    gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, geom.indices, gl.STATIC_DRAW);
    gl.bindVertexArray(null);
    return {vao, count: geom.indices.length};
  }

  begin(proj, view, eye, bg) {
    const gl = this.gl;
    gl.viewport(0, 0, this.canvas.width, this.canvas.height);
    gl.clearColor(bg[0], bg[1], bg[2], 1.0);
    gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
    gl.useProgram(this.prog);
    gl.uniformMatrix4fv(this.u.u_proj, false, proj);
    gl.uniformMatrix4fv(this.u.u_view, false, view);
    gl.uniform3fv(this.u.u_eye, eye);
  }

  draw(mesh, model, color, flat) {
    const gl = this.gl;
    gl.uniformMatrix4fv(this.u.u_model, false, model);
    gl.uniform3fv(this.u.u_color, color);
    gl.uniform1f(this.u.u_flat, flat ? 1.0 : 0.0);
    gl.bindVertexArray(mesh.vao);
    gl.drawElements(gl.TRIANGLES, mesh.count, gl.UNSIGNED_INT, 0);
    gl.bindVertexArray(null);
  }
}

/* ----------------------------- scene ------------------------------ */

const BODY_COLORS = [
  [0.31, 0.47, 1.0], [1.0, 0.44, 0.35], [0.25, 0.83, 0.64], [1.0, 0.78, 0.34],
  [0.71, 0.49, 0.91], [0.44, 0.83, 1.0], [1.0, 0.62, 0.70], [0.65, 0.82, 0.16],
  [0.95, 0.52, 0.16], [0.53, 0.60, 0.67],
];

function hover(c) { return [Math.min(c[0]+0.35,1), Math.min(c[1]+0.35,1), Math.min(c[2]+0.35,1)]; }
const SELECT_COLOR = [0.13, 0.58, 0.81];

function buildScene(system, renderer) {
  // a body = {name, draws: [{mesh, local(mat4), kind}], visible, color}
  const bodies = [];
  const meshGeoms = (system.config && system.config.meshGeometries) || {};
  (system.config.bodies || []).forEach((body, i) => {
    const draws = [];
    (body.colliders || []).forEach((col) => {
      if (col.hidden) return;
      let geom = null, ground = false;
      if (col.capsule) {
        geom = geoCapsule(col.capsule.radius, col.capsule.length, 24, 8);
      } else if (col.sphere) {
        geom = geoCapsule(col.sphere.radius, 2 * col.sphere.radius, 24, 8);
      } else if (col.box) {
        const h = col.box.halfsize;
        geom = geoBox(h[0], h[1], h[2]);
      } else if (col.plane) {
        geom = geoGrid(2000, 1, null); ground = true;
      } else if (col.clippedPlane) {
        geom = geoGrid(2 * (col.clippedPlane.halfsizeX || 0.5), 1, null);
      } else if (col.heightMap) {
        const n = Math.round(Math.sqrt(col.heightMap.data.length));
        geom = geoGrid(col.heightMap.size, n - 1, col.heightMap.data);
        ground = true;
      } else if (col.mesh && meshGeoms[col.mesh.name]) {
        const mg = meshGeoms[col.mesh.name];
        geom = geoTrimesh(mg.vertices, mg.faces, col.mesh.scale || 1.0);
      } else {
        return;
      }
      const p = col.position || [0, 0, 0];
      const r = col.rotation || [0, 0, 0];
      const local = mat4FromQuatPos(quatFromEulerXYZ(r[0], r[1], r[2]), p);
      draws.push({mesh: renderer.upload(geom), local, ground});
    });
    bodies.push({
      name: body.name || `body_${i}`,
      draws,
      visible: true,
      color: BODY_COLORS[i % BODY_COLORS.length],
      model: mat4Identity(),
      pos: [0, 0, 0],
      rot: [1, 0, 0, 0],
    });
  });

  // contact overlay dots (shared unit sphere, scaled at draw time)
  const dot = renderer.upload(geoCapsule(1.0, 2.0, 10, 4));
  // debug axes: one thin box per axis, colored at draw
  const axis = renderer.upload(geoBox(0.5, 0.02, 0.02));
  return {bodies, dot, axis};
}

function setFrame(system, scene, t) {
  const pos = system.pos[t];
  const rot = system.rot[t];
  scene.bodies.forEach((b, i) => {
    b.pos = pos[i];
    b.rot = rot[i];  // (w, x, y, z)
    b.model = mat4FromQuatPos(rot[i], pos[i]);
  });
}

/* ------------------------- orbit controls ------------------------- */

class OrbitControls {
  constructor(canvas, target, radius) {
    this.canvas = canvas;
    this.target = target.slice();
    this.radius = radius;
    this.theta = Math.PI / 4;   // azimuth
    this.phi = Math.PI / 3;     // polar from +z
    this.onchange = null;
    this._drag = null;
    canvas.addEventListener('pointerdown', (e) => {
      this._drag = {x: e.clientX, y: e.clientY, btn: e.button, moved: false};
      canvas.setPointerCapture(e.pointerId);
    });
    canvas.addEventListener('pointermove', (e) => {
      if (!this._drag) return;
      const dx = e.clientX - this._drag.x, dy = e.clientY - this._drag.y;
      if (Math.abs(dx) + Math.abs(dy) > 3) this._drag.moved = true;
      this._drag.x = e.clientX; this._drag.y = e.clientY;
      if (this._drag.btn === 0) {          // rotate
        this.theta -= dx * 0.008;
        this.phi = Math.min(Math.max(this.phi - dy * 0.008, 0.05), Math.PI - 0.05);
      } else {                              // pan in view plane
        const s = this.radius * 0.002;
        const [ex, ey] = [Math.cos(this.theta), Math.sin(this.theta)];
        this.target[0] += (-ey * -dx + ex * dy * Math.cos(this.phi)) * s;
        this.target[1] += (ex * -dx + ey * dy * Math.cos(this.phi)) * s;
        this.target[2] += dy * Math.sin(this.phi) * s;
      }
      if (this.onchange) this.onchange();
    });
    canvas.addEventListener('pointerup', (e) => {
      const wasClick = this._drag && !this._drag.moved;
      this._drag = null;
      if (wasClick && this.onclick) this.onclick(e);
    });
    canvas.addEventListener('wheel', (e) => {
      e.preventDefault();
      this.radius *= Math.exp(e.deltaY * 0.001);
      this.radius = Math.min(Math.max(this.radius, 0.05), 5000);
      if (this.onchange) this.onchange();
    }, {passive: false});
    canvas.addEventListener('contextmenu', (e) => e.preventDefault());
  }

  eye() {
    return [
      this.target[0] + this.radius * Math.sin(this.phi) * Math.cos(this.theta),
      this.target[1] + this.radius * Math.sin(this.phi) * Math.sin(this.theta),
      this.target[2] + this.radius * Math.cos(this.phi),
    ];
  }
}

/* ------------------------------ UI -------------------------------- */

function el(tag, css, parent) {
  const e = document.createElement(tag);
  if (css) e.style.cssText = css;
  if (parent) parent.appendChild(e);
  return e;
}

function startViewer(system, container) {
  container.style.position = 'relative';
  const width = container.clientWidth || window.innerWidth;
  const height = container.clientHeight || Math.round(window.innerHeight * 0.9);

  const canvas = el('canvas', 'display:block', container);
  canvas.width = width; canvas.height = height - 40;
  const renderer = new Renderer(canvas);
  const scene = buildScene(system, renderer);
  const nFrames = system.pos.length;
  setFrame(system, scene, 0);

  /* camera framed on first-frame bounding sphere */
  const centers = system.pos[0];
  let cx = 0, cy = 0, cz = 0;
  centers.forEach((p) => { cx += p[0]; cy += p[1]; cz += p[2]; });
  cx /= centers.length; cy /= centers.length; cz /= centers.length;
  let r = 1;
  centers.forEach((p) => {
    r = Math.max(r, Math.hypot(p[0]-cx, p[1]-cy, p[2]-cz));
  });
  const controls = new OrbitControls(canvas, [cx, cy, cz], 3.5 * r);

  /* playback bar */
  const bar = el('div',
      'display:flex;gap:8px;align-items:center;padding:6px;height:28px;' +
      'font-family:monospace;font-size:13px;background:#11131a;color:#dde', container);
  const btn = el('button', '', bar); btn.textContent = '⏸';
  const stepB = el('button', '', bar); stepB.textContent = '⏮';
  const stepF = el('button', '', bar); stepF.textContent = '⏭';
  const slider = el('input', 'flex:1', bar);
  slider.type = 'range'; slider.min = 0; slider.max = nFrames - 1; slider.value = 0;
  const speedSel = el('select', '', bar);
  for (const s of [0.25, 0.5, 1, 2, 4]) {
    const o = el('option', '', speedSel);
    o.value = s; o.textContent = s + 'x';
    if (s === 1) o.selected = true;
  }
  const loopB = el('button', '', bar); loopB.textContent = '🔁';
  const shotB = el('button', '', bar); shotB.textContent = '📷';
  const label = el('span', 'min-width:90px;text-align:right', bar);

  /* side panel: body list + selected-body readout */
  const panel = el('div',
      'position:absolute;top:8px;right:8px;width:220px;max-height:70%;overflow:auto;' +
      'background:rgba(17,19,26,0.92);color:#dde;font:12px monospace;' +
      'border:1px solid #334;border-radius:6px;padding:8px', container);
  const panelTitle = el('div', 'font-weight:bold;margin-bottom:6px', panel);
  panelTitle.textContent = 'bodies';
  const bodyRows = [];
  scene.bodies.forEach((b, i) => {
    const row = el('div', 'display:flex;gap:6px;align-items:center;cursor:pointer;padding:1px 0', panel);
    const chk = el('input', '', row); chk.type = 'checkbox'; chk.checked = true;
    chk.onchange = () => { b.visible = chk.checked; };
    const swatch = el('span',
        `display:inline-block;width:10px;height:10px;border-radius:2px;background:rgb(${
            b.color.map((c)=>Math.round(c*255)).join(',')})`, row);
    const name = el('span', 'flex:1', row);
    name.textContent = b.name;
    row.onclick = (e) => { if (e.target !== chk) select(i === selected ? null : i); };
    bodyRows.push({row, name});
  });
  const info = el('div', 'margin-top:8px;border-top:1px solid #334;padding-top:6px;white-space:pre', panel);
  const debugRow = el('label', 'display:block;margin-top:6px', panel);
  const debugChk = el('input', '', debugRow); debugChk.type = 'checkbox';
  debugChk.checked = !!system.debug;
  debugRow.appendChild(document.createTextNode(' debug (axes + contacts)'));

  /* state */
  let playing = true;
  let frame = 0;
  let selected = null;
  let hovered = null;
  let loop = true;
  const dt = Math.max(system.config.dt || 0.033, 1 / 120);

  function select(i) {
    selected = i;
    bodyRows.forEach((r, j) => {
      r.row.style.background = (j === selected) ? '#2a3350' : '';
    });
  }

  btn.onclick = () => { playing = !playing; btn.textContent = playing ? '⏸' : '▶'; };
  stepB.onclick = () => { playing = false; btn.textContent = '▶'; frame = (frame + nFrames - 1) % nFrames; slider.value = frame; };
  stepF.onclick = () => { playing = false; btn.textContent = '▶'; frame = (frame + 1) % nFrames; slider.value = frame; };
  slider.oninput = () => { frame = Number(slider.value); playing = false; btn.textContent = '▶'; };
  loopB.onclick = () => { loop = !loop; loopB.style.opacity = loop ? 1.0 : 0.4; };
  shotB.onclick = () => {
    const a = document.createElement('a');
    a.download = 'brax_tpu_frame_' + frame + '.png';
    a.href = canvas.toDataURL('image/png');
    a.click();
  };

  /* GPU picking: flat-color pass keyed by body index, read 1 pixel */
  function pick(x, y) {
    const gl = renderer.gl;
    gl.bindFramebuffer(gl.FRAMEBUFFER, renderer.pickFbo);
    const proj = mat4Perspective(50, canvas.width / canvas.height, 0.01, 5000);
    const eye = controls.eye();
    const view = mat4LookAt(eye, controls.target, [0, 0, 1]);
    renderer.begin(proj, view, eye, [0, 0, 0]);
    scene.bodies.forEach((b, i) => {
      if (!b.visible) return;
      const id = i + 1;
      const color = [((id>>4)&15)/15, (id&15)/15, 0];
      b.draws.forEach((d) => {
        renderer.draw(d.mesh, mat4Mul(b.model, d.local), color, true);
      });
    });
    const px = new Uint8Array(4);
    gl.readPixels(Math.max(0, Math.floor(x)),
                  Math.max(0, Math.floor(canvas.height - y)),
                  1, 1, gl.RGBA, gl.UNSIGNED_BYTE, px);
    gl.bindFramebuffer(gl.FRAMEBUFFER, null);
    const id = (Math.round(px[0]/255*15)<<4) | Math.round(px[1]/255*15);
    return id > 0 && id <= scene.bodies.length ? id - 1 : null;
  }

  controls.onclick = (e) => {
    const rect = canvas.getBoundingClientRect();
    const i = pick(e.clientX - rect.left, e.clientY - rect.top);
    select(i);
  };
  canvas.addEventListener('pointermove', (e) => {
    if (e.buttons) return;  // dragging = orbiting
    const rect = canvas.getBoundingClientRect();
    hovered = pick(e.clientX - rect.left, e.clientY - rect.top);
    canvas.style.cursor = hovered === null ? 'auto' : 'pointer';
  });

  /* render loop */
  let last = performance.now();
  let acc = 0;
  function animate(now) {
    requestAnimationFrame(animate);
    const speed = Number(speedSel.value);
    acc += (now - last) / 1000 * speed; last = now;
    if (playing && acc >= dt) {
      let next = frame + Math.floor(acc / dt);
      if (loop) next %= nFrames;
      else if (next >= nFrames) { next = nFrames - 1; playing = false; btn.textContent = '▶'; }
      frame = next;
      acc = acc % dt;
      slider.value = frame;
    }
    label.textContent = `${frame}/${nFrames - 1}`;
    setFrame(system, scene, frame);

    const proj = mat4Perspective(50, canvas.width / canvas.height, 0.01, 5000);
    const eye = controls.eye();
    const view = mat4LookAt(eye, controls.target, [0, 0, 1]);
    renderer.begin(proj, view, eye, [0.106, 0.118, 0.153]);
    scene.bodies.forEach((b, i) => {
      if (!b.visible) return;
      let color = b.color;
      if (i === selected) color = SELECT_COLOR;
      else if (i === hovered) color = hover(b.color);
      b.draws.forEach((d) => {
        renderer.draw(d.mesh, mat4Mul(b.model, d.local),
                      d.ground ? [0.45, 0.47, 0.50] : color, false);
      });
      if (debugChk.checked) {   // body-frame axes
        const axisCols = [[1,0.2,0.2],[0.2,1,0.2],[0.3,0.4,1]];
        const rots = [
          [1,0,0,0],
          quatFromEulerXYZ(0,0,90),
          quatFromEulerXYZ(0,-90,0),
        ];
        rots.forEach((q, k) => {
          const m = mat4Mul(b.model, mat4Mul(mat4FromQuatPos(q, [0,0,0]),
              mat4FromQuatPos([1,0,0,0], [0.5, 0, 0])));
          renderer.draw(scene.axis, m, axisCols[k], true);
        });
      }
    });

    /* contact overlay */
    if (debugChk.checked && system.contact_pos && system.contact_pos.length) {
      const cpos = system.contact_pos[frame] || [];
      const cpen = system.contact_penetration[frame] || [];
      for (let i = 0; i < cpos.length; i++) {
        if (!(cpen[i] > 0)) continue;
        const m = mat4FromQuatPos([1, 0, 0, 0], cpos[i]);
        // scale the unit dot to 4 cm
        for (let k = 0; k < 3; k++) { m[k] *= 0.04; m[4+k] *= 0.04; m[8+k] *= 0.04; }
        renderer.draw(scene.dot, m, [1.0, 0.15, 0.15], true);
      }
    }

    /* selected-body readout (parity: reference Bodies GUI folders) */
    if (selected !== null) {
      const b = scene.bodies[selected];
      info.textContent =
          `${b.name}\n` +
          `pos ${b.pos.map((v)=>v.toFixed(3)).join(' ')}\n` +
          `rot ${b.rot.map((v)=>v.toFixed(3)).join(' ')}`;
    } else {
      info.textContent = 'click a body to inspect';
    }
  }
  requestAnimationFrame(animate);
  return {scene, controls};  // exposed for testing
}

/* exports for DOM-free smoke tests (python/CI) and the page bootstrap */
if (typeof window !== 'undefined' && typeof system !== 'undefined') {
  window.addEventListener('DOMContentLoaded', () => {
    window._brax_viewer = startViewer(system, document.getElementById('brax-tpu-viewer'));
  });
}
