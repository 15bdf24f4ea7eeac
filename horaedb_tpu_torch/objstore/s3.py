"""S3-compatible ObjectStore over aiohttp with SigV4 signing
(counterpart of horaedb_tpu/objstore/s3.py: the same requests, headers
and signatures).

The reference defines a full S3 config but panics "S3 not support yet"
(ref: src/server/src/main.rs:112, config.rs:82-160).  This client
implements the five-verb contract against any S3-compatible endpoint
(AWS, MinIO, GCS-interop): AWS Signature Version 4, path-style
addressing, ListObjectsV2 with continuation, ranged reads — plus the
production surface the reference's config models:

- bounded retries with exponential backoff + jitter on connection
  errors, timeouts, and retryable statuses (5xx/429), re-signing each
  attempt (max_retries, ref: config.rs default_max_retries);
- non-IO vs IO timeouts (timeout/io_timeout, ref: TimeoutOptions) and a
  per-host connection pool cap (ref: HttpOptions);
- multipart upload for objects over multipart_threshold (large SSTs),
  parts uploaded concurrently, aborted on failure;
- an optional key prefix (ref: S3LikeStorageConfig.prefix).

Payloads are signed with their SHA-256 (no UNSIGNED-PAYLOAD), so a
corrupted body is rejected by the server.  DELETE is S3-native
idempotent (one round trip; missing keys succeed) — the engine's
deletes are background/best-effort fan-outs.  Set
S3Options.strict_delete for the strict ObjectStore contract
(NotFoundError via a HEAD probe).  A retried multipart initiate sweeps
stray upload ids it may have created (ListMultipartUploads + abort),
so orphaned uploads don't silently accrue storage.
"""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import hmac
import random
import re
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Optional

import aiohttp
import yarl

from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.objstore.api import (
    DEFAULT_STREAM_CHUNK,
    NotFoundError,
    ObjectMeta,
    ObjectStore,
)

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
_RETRYABLE_STATUSES = {429, 500, 502, 503, 504}


@dataclass
class S3Options:
    endpoint: str  # e.g. "http://127.0.0.1:9000"
    region: str
    bucket: str
    access_key_id: str
    secret_access_key: str
    # key prefix inside the bucket (ref: S3LikeStorageConfig.prefix)
    prefix: str = ""
    # bounded retry with backoff (ref: default_max_retries = 3)
    max_retries: int = 3
    retry_base_backoff_s: float = 0.1
    # non-IO (head/delete/list) vs IO (get/put) deadlines, seconds
    # (ref: TimeoutOptions)
    timeout_s: float = 10.0
    io_timeout_s: float = 10.0
    # connection pool cap (ref: HttpOptions.pool_max_idle_per_host)
    pool_max_per_host: int = 64
    # objects at/above this upload via multipart in part_size chunks
    multipart_threshold: int = 64 << 20
    multipart_part_size: int = 16 << 20
    multipart_concurrency: int = 4
    # When True, DELETE probes with HEAD first so missing keys raise
    # NotFoundError (the strict ObjectStore contract).  Default False:
    # the engine's deletes are best-effort background fan-outs
    # (compaction inputs, manifest deltas) and the extra HEAD doubles
    # round trips on exactly that hot path — S3's native idempotent
    # DELETE (204 for missing keys) is the right trade.
    strict_delete: bool = False

    def __post_init__(self) -> None:
        # a trailing slash would double up in signed paths and fail every
        # signature check
        self.endpoint = self.endpoint.rstrip("/")
        self.prefix = self.prefix.strip("/")


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _uri_encode(s: str, *, encode_slash: bool) -> str:
    safe = "-._~" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


def _xml_text(body: bytes, tag: str) -> str:
    """Text of the first `tag` element, namespace-agnostic."""
    root = ET.fromstring(body)
    for el in root.iter():
        if el.tag == tag or el.tag.endswith("}" + tag):
            return el.text or ""
    return ""


def _canonical_query(query: dict[str, str]) -> str:
    """AWS-canonical query string — used both for signing and for the
    URL actually sent, so signed and sent bytes cannot diverge (aiohttp's
    yarl encoding differs from AWS's, e.g. '/' left raw in values)."""
    return "&".join(
        f"{_uri_encode(k, encode_slash=True)}="
        f"{_uri_encode(v, encode_slash=True)}"
        for k, v in sorted(query.items()))


class SigV4Signer:
    """AWS Signature Version 4 (the s3 service flavor: single-chunk,
    signed payload hash)."""

    def __init__(self, opts: S3Options):
        self.opts = opts

    def sign(self, method: str, path: str, canonical_query: str,
             payload_sha256: str,
             now: Optional[datetime.datetime] = None) -> dict[str, str]:
        """canonical_query MUST be the exact query string sent on the
        wire (produced by _canonical_query) — taking the string rather
        than a dict makes signed==sent structural, not coincidental."""
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        host = urllib.parse.urlparse(self.opts.endpoint).netloc

        headers = {
            "host": host,
            "x-amz-content-sha256": payload_sha256,
            "x-amz-date": amz_date,
        }
        signed_headers = ";".join(sorted(headers))
        canonical_headers = "".join(
            f"{k}:{headers[k].strip()}\n" for k in sorted(headers))
        canonical_request = "\n".join([
            method, _uri_encode(path, encode_slash=False), canonical_query,
            canonical_headers, signed_headers, payload_sha256,
        ])

        scope = f"{datestamp}/{self.opts.region}/s3/aws4_request"
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ])
        k = _hmac(("AWS4" + self.opts.secret_access_key).encode(), datestamp)
        k = _hmac(k, self.opts.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(),
                             hashlib.sha256).hexdigest()

        return {
            "x-amz-content-sha256": payload_sha256,
            "x-amz-date": amz_date,
            "Authorization": (
                f"AWS4-HMAC-SHA256 "
                f"Credential={self.opts.access_key_id}/{scope}, "
                f"SignedHeaders={signed_headers}, Signature={signature}"),
        }


class S3ObjectStore(ObjectStore):
    def __init__(self, opts: S3Options,
                 session: Optional[aiohttp.ClientSession] = None):
        self.opts = opts
        self.signer = SigV4Signer(opts)
        self._session = session
        self._own_session = session is None

    async def _ensure(self) -> aiohttp.ClientSession:
        if self._session is None:
            self._session = aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(
                    limit_per_host=self.opts.pool_max_per_host))
        return self._session

    async def close(self) -> None:
        if self._own_session and self._session is not None:
            await self._session.close()
            self._session = None

    def _path(self, key: str) -> str:
        if self.opts.prefix:
            return f"/{self.opts.bucket}/{self.opts.prefix}/{key.lstrip('/')}"
        return f"/{self.opts.bucket}/{key.lstrip('/')}"

    async def _request(self, method: str, key: str,
                       query: Optional[dict[str, str]] = None,
                       data=b"",
                       extra_headers: Optional[dict] = None,
                       ok_status=(200,), io: bool = True,
                       collect: bool = False,
                       attempts_out: Optional[list] = None):
        """One S3 request with bounded retries: each attempt is re-signed
        (the date header changes) and backed off exponentially with
        jitter.  Callers only pass verbs that are safe to retry (the
        non-idempotent multipart complete handles its own lost-response
        case).  IO requests use progress-based timeouts (connect +
        socket read) rather than a total deadline, so a slow transfer
        that IS making progress never fails.

        With collect=True the body is read INSIDE the retry loop (a
        connection dying mid-body is retried like any other transient
        failure) and (response, body) is returned; otherwise the caller
        owns the unread response.

        `attempts_out`, when given, receives the number of attempts
        actually sent — callers with non-idempotent verbs (multipart
        initiate) use it to detect that a retry may have left server-side
        state behind."""
        query = query or {}
        path = self._path(key) if key is not None else f"/{self.opts.bucket}"
        payload_hash = (hashlib.sha256(data).hexdigest()
                        if data else _EMPTY_SHA256)
        cq = _canonical_query(query)
        # send the EXACT bytes that were signed: canonical-encoded path +
        # canonical query, marked pre-encoded so yarl doesn't re-quote
        url = yarl.URL(
            self.opts.endpoint + _uri_encode(path, encode_slash=False)
            + (f"?{cq}" if cq else ""),
            encoded=True)
        if io:
            timeout = aiohttp.ClientTimeout(connect=self.opts.timeout_s,
                                            sock_read=self.opts.io_timeout_s)
        else:
            timeout = aiohttp.ClientTimeout(total=self.opts.timeout_s)
        session = await self._ensure()

        last_err: Optional[str] = None
        for attempt in range(self.opts.max_retries + 1):
            if attempts_out is not None:
                attempts_out.append(attempt + 1)
            if attempt:
                backoff = (self.opts.retry_base_backoff_s * (2 ** (attempt - 1))
                           * (1 + random.random()))
                await asyncio.sleep(backoff)
            headers = self.signer.sign(method, path, cq, payload_hash)
            if extra_headers:
                headers.update(extra_headers)
            try:
                resp = await session.request(method, url, data=data,
                                             headers=headers,
                                             timeout=timeout)
                if resp.status in _RETRYABLE_STATUSES:
                    try:
                        detail = (await resp.text())[:200]
                    finally:
                        resp.release()
                    last_err = f"status {resp.status}: {detail}"
                    continue
                if resp.status == 404:
                    resp.release()
                    raise NotFoundError(f"object not found: {key}")
                if resp.status not in ok_status:
                    text = (await resp.text())[:300]
                    raise Error(f"s3 {method} {path} failed "
                                f"({resp.status}): {text}")
                if collect:
                    body = await resp.read()
                    resp.release()
                    return resp, body
                return resp
            except (aiohttp.ClientError, asyncio.TimeoutError) as e:
                last_err = f"{type(e).__name__}: {e}"
                continue
        raise Error(f"s3 {method} {path} failed after "
                    f"{self.opts.max_retries + 1} attempts: {last_err}")

    # ---- ObjectStore ------------------------------------------------------

    async def put(self, path: str, data: bytes) -> None:
        if len(data) >= self.opts.multipart_threshold:
            await self._put_multipart(path, data)
            return
        resp = await self._request("PUT", path, data=data)
        resp.release()

    async def _initiate_multipart(self, path: str) -> str:
        """CreateMultipartUpload; a RETRIED initiate may have created an
        upload whose response was lost — that orphan would accrue
        storage until a bucket lifecycle rule fires.  SST keys have
        exactly one writer, so any OTHER in-progress upload for the key
        is a stray from our own retries: sweep them (best-effort)."""
        attempts: list = []
        _resp, body = await self._request("POST", path,
                                          query={"uploads": ""},
                                          collect=True,
                                          attempts_out=attempts)
        upload_id = _xml_text(body, "UploadId")
        if not upload_id:
            raise Error(f"s3 multipart initiate returned no UploadId "
                        f"for {path}")
        if len(attempts) > 1:
            await self._abort_stray_uploads(path, keep=upload_id)
        return upload_id

    async def _abort_multipart(self, path: str, upload_id: str) -> None:
        """Best-effort AbortMultipartUpload (the caller's error wins)."""
        try:
            r = await self._request("DELETE", path,
                                    query={"uploadId": upload_id},
                                    ok_status=(200, 204), io=False)
            r.release()
        except Exception:
            pass

    @staticmethod
    def _complete_xml(etags: list[tuple[int, str]]) -> bytes:
        parts = "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
            for n, e in etags)
        return (f"<CompleteMultipartUpload>{parts}"
                f"</CompleteMultipartUpload>").encode()

    @staticmethod
    def _expected_multipart_etag(etags: list[tuple[int, str]]
                                 ) -> Optional[str]:
        """The S3 multipart ETag is md5(concat(part md5s))-N and the
        part PUT responses already carry each part's md5 — build the
        expected object ETag from them (no client-side hashing) so a
        lost complete response can be verified.  SSE-KMS/SSE-C buckets
        return non-md5 part ETags; returns None there (size fallback
        still applies)."""
        try:
            digests = b"".join(bytes.fromhex(e.strip('"'))
                               for _n, e in etags)
            return f"{hashlib.md5(digests).hexdigest()}-{len(etags)}"
        except ValueError:
            return None

    async def _put_multipart(self, path: str, data: bytes) -> None:
        """Multipart upload: initiate, upload parts concurrently (each
        part retried independently by _request), complete; abort on any
        failure so no orphaned upload accrues storage."""
        upload_id = await self._initiate_multipart(path)
        part_size = self.opts.multipart_part_size
        view = memoryview(data)  # parts slice lazily — no payload copy
        n_parts = -(-len(data) // part_size)
        sem = asyncio.Semaphore(max(1, self.opts.multipart_concurrency))

        async def upload(num: int) -> tuple[int, str]:
            async with sem:
                chunk = view[(num - 1) * part_size: num * part_size]
                r = await self._request(
                    "PUT", path,
                    query={"partNumber": str(num), "uploadId": upload_id},
                    data=chunk)
                etag = r.headers.get("ETag", "")
                r.release()
                return num, etag

        try:
            tasks = [asyncio.create_task(upload(i + 1))
                     for i in range(n_parts)]
            try:
                etags = await asyncio.gather(*tasks)
            except BaseException:
                # stop in-flight siblings BEFORE aborting: parts racing
                # the abort can still be stored as orphans
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                raise
            etags = list(etags)
            await self._complete_multipart(
                path, upload_id, self._complete_xml(etags),
                self._expected_multipart_etag(etags), len(data))
        except BaseException:
            await self._abort_multipart(path, upload_id)
            raise

    async def put_stream(self, path: str, chunks) -> int:
        """Streaming put: chunks accumulate to multipart part size and
        upload as they fill, so peak memory is ~one part (16 MiB
        default), not the object.  Objects that finish under the
        multipart threshold fall back to one ordinary PUT.  On any
        failure the in-progress upload is aborted — no readable object
        and no orphaned parts."""
        part_size = self.opts.multipart_part_size
        buf = bytearray()
        upload_id: Optional[str] = None
        etags: list[tuple[int, str]] = []
        total = 0

        async def upload_part(data: bytes) -> None:
            nonlocal upload_id
            if upload_id is None:
                upload_id = await self._initiate_multipart(path)
            num = len(etags) + 1
            r = await self._request(
                "PUT", path,
                query={"partNumber": str(num), "uploadId": upload_id},
                data=data)
            etags.append((num, r.headers.get("ETag", "")))
            r.release()

        try:
            async for chunk in chunks:
                buf += chunk
                total += len(chunk)
                while len(buf) >= part_size:
                    await upload_part(bytes(buf[:part_size]))
                    del buf[:part_size]
            if upload_id is None:
                # small object: single PUT, no multipart bookkeeping
                await self.put(path, bytes(buf))
                return total
            if buf or not etags:
                await upload_part(bytes(buf))
            await self._complete_multipart(
                path, upload_id, self._complete_xml(etags),
                self._expected_multipart_etag(etags), total)
            return total
        except BaseException:
            if upload_id is not None:
                await self._abort_multipart(path, upload_id)
            raise

    async def _abort_stray_uploads(self, key: str, keep: str) -> None:
        """Abort in-progress multipart uploads for `key` other than
        `keep` (our live upload id).  Best-effort: listing may not be
        supported by every S3-alike, and a failure here must not fail
        the actual upload."""
        full_key = (f"{self.opts.prefix}/{key.lstrip('/')}" if self.opts.prefix
                    else key.lstrip("/"))
        try:
            _resp, body = await self._request(
                "GET", None, query={"uploads": "", "prefix": full_key},
                collect=True, io=False)
            root = ET.fromstring(body)
            strays = []
            for el in root.iter():
                if el.tag == "Upload" or el.tag.endswith("}Upload"):
                    k = uid = None
                    for child in el:
                        if child.tag == "Key" or child.tag.endswith("}Key"):
                            k = child.text
                        elif (child.tag == "UploadId"
                              or child.tag.endswith("}UploadId")):
                            uid = child.text
                    if k == full_key and uid and uid != keep:
                        strays.append(uid)
        except Exception:
            return  # listing failed; lifecycle rules are the backstop
        for uid in strays:
            try:
                r = await self._request("DELETE", key,
                                        query={"uploadId": uid},
                                        ok_status=(200, 204), io=False)
                r.release()
            except Exception:
                # one already-reaped (404) or failing abort must not
                # stop the sweep of the remaining strays
                continue

    async def _complete_multipart(self, path: str, upload_id: str,
                                  xml: bytes, expected_etag: str,
                                  expected_size: int) -> None:
        """CompleteMultipartUpload is NOT idempotent: a retry after a
        lost success response gets 404 NoSuchUpload — confirm via HEAD
        that OUR object landed (not a stale previous object at the same
        overwritten key) before treating that as success.  A 200 can
        also carry an error body (AWS documents InternalError-in-200
        for this call), which must not pass as success."""
        try:
            _resp, body = await self._request(
                "POST", path, query={"uploadId": upload_id}, data=xml,
                collect=True)
            if b"<Error" in body or not body:
                raise Error(f"s3 multipart complete for {path} returned "
                            f"an error body: {body[:200]!r}")
        except NotFoundError:
            # a previous attempt whose response was lost may have
            # completed the upload; verify the object at the key is OURS
            resp = await self._request("HEAD", path, io=False)
            etag = resp.headers.get("ETag", "").strip('"')
            size = int(resp.headers.get("Content-Length", -1))
            resp.release()
            # only an md5-shaped multipart ETag ("<32 hex>-N") is
            # comparable; encrypted buckets produce opaque ETags — fall
            # back to the size check there
            comparable = (expected_etag is not None and etag
                          and re.fullmatch(r"[0-9a-f]{32}-\d+", etag))
            if comparable:
                if etag != expected_etag:
                    raise Error(
                        f"s3 multipart complete for {path} lost its "
                        f"upload and the object present has ETag {etag} "
                        f"!= expected {expected_etag} (stale object)")
            elif size != expected_size:
                raise Error(
                    f"s3 multipart complete for {path} lost its upload "
                    f"and the object present has size {size} != "
                    f"expected {expected_size}")

    async def get(self, path: str) -> bytes:
        _resp, body = await self._request("GET", path, collect=True)
        return body

    async def get_stream(self, path: str,
                         chunk_size: int = DEFAULT_STREAM_CHUNK):
        """Chunked ranged GETs: one HEAD for the size, then sequential
        Range reads — a whole-SST fetch holds one chunk resident
        instead of the object.  (S3's own GET response could stream
        too, but ranged reads keep each wire op bounded and retryable
        by the backend's protocol-level retry loop.)"""
        meta = await self.head(path)
        off = 0
        while off < meta.size:
            end = min(meta.size, off + max(1, chunk_size))
            yield await self.get_range(path, off, end)
            off = end

    async def get_range(self, path: str, start: int, end: int) -> bytes:
        resp, data = await self._request(
            "GET", path, extra_headers={"Range": f"bytes={start}-{end - 1}"},
            ok_status=(200, 206), collect=True)
        if resp.status == 200:
            # endpoint (or a proxy) ignored the Range header: slice here
            # so callers always get exactly [start, end)
            return data[start:end]
        return data

    async def head(self, path: str) -> ObjectMeta:
        resp = await self._request("HEAD", path, io=False)
        try:
            return ObjectMeta(path=path,
                              size=int(resp.headers.get("Content-Length", 0)))
        finally:
            resp.release()

    async def delete(self, path: str) -> None:
        # S3 DELETE is idempotent (204 for missing keys).  Only
        # strict_delete pays a HEAD probe to honor the ObjectStore
        # contract's NotFoundError; the default single round trip is
        # what the engine's best-effort background deletes want.
        if self.opts.strict_delete:
            await self.head(path)
        resp = await self._request("DELETE", path, ok_status=(200, 204),
                                   io=False)
        resp.release()

    async def list(self, prefix: str) -> list[ObjectMeta]:
        out: list[ObjectMeta] = []
        token: Optional[str] = None
        # the configured bucket prefix is transparent to callers: it is
        # prepended on the wire and stripped from returned keys
        wire_prefix = prefix.lstrip("/")
        strip = ""
        if self.opts.prefix:
            strip = self.opts.prefix + "/"
            wire_prefix = strip + wire_prefix
        while True:
            query = {"list-type": "2", "prefix": wire_prefix}
            if token:
                query["continuation-token"] = token
            _resp, body = await self._request("GET", None, query=query,
                                              io=False, collect=True)
            root = ET.fromstring(body)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for contents in root.findall(f"{ns}Contents"):
                key = contents.find(f"{ns}Key").text or ""
                size = int(contents.find(f"{ns}Size").text or 0)
                if strip and key.startswith(strip):
                    key = key[len(strip):]
                out.append(ObjectMeta(path=key, size=size))
            truncated = (root.findtext(f"{ns}IsTruncated") == "true")
            token = root.findtext(f"{ns}NextContinuationToken")
            if not truncated or not token:
                break
        out.sort(key=lambda m: m.path)
        return out
