"""The port's WebRTC stack (``selkies_tpu_torch/webrtc``) against the JAX
package's (``selkies_tpu/webrtc``).

Every case of the JAX package's transport tests (``test_webrtc_dtls.py``,
``_fec``, ``_ice``, ``_media``, ``_pc``, ``_rtp`` and ``_sctp``) runs
against the port's copies through ``tests/torch_port_cases.py``, but one:
``test_webrtc_pc.py::test_decode_planes_huge_nsym_rejected`` tests
``encoder/rans.py``, an rANS coder that is not part of WebRTC, which
nothing in the JAX package imports and which the port does not carry.

Beyond those cases: the two copies give the same bytes on the same
numpy-seeded inputs (RTP/RTCP packets, the H.264 payloader's packets,
STUN messages with a fixed transaction id, an SDP parsed and serialised,
SRTP/SRTCP protected with the same keys, the ULPFEC packets of one group,
the GCC estimator's bitrate over one arrival trace), and a JAX
PeerConnection and a port PeerConnection speak one wire on loopback,
either one the offerer: video access units, Opus frames and the ``input``
data channel's messages arrive intact.
"""

import asyncio
import dataclasses
import sys
import types

import numpy as np
import pytest

from torch_port_cases import case_names, load_cases, run_case

pytest.importorskip("jax")
pytest.importorskip("cryptography")

from selkies_tpu.webrtc import (  # noqa: E402
    fec as jfec, h264 as jh264, peerconnection as jpc, rate as jrate,
    rtp as jrtp, sdp as jsdp, srtp as jsrtp, stun as jstun, ice as jice)
from selkies_tpu_torch.webrtc import (  # noqa: E402
    fec as tfec, h264 as th264, peerconnection as tpc, rate as trate,
    rtp as trtp, sdp as tsdp, srtp as tsrtp, stun as tstun, ice as tice)

FILES = ("test_webrtc_dtls.py", "test_webrtc_fec.py", "test_webrtc_ice.py",
         "test_webrtc_media.py", "test_webrtc_pc.py", "test_webrtc_rtp.py",
         "test_webrtc_sctp.py")
#: the one case left out: it tests encoder/rans.py, not WebRTC, and the
#: port does not carry rans.py (nothing in the JAX package imports it)
EXCLUDED = {("test_webrtc_pc.py", "test_decode_planes_huge_nsym_rejected")}

JAX_CASES = {f: load_cases(f, port=False) for f in FILES}
# the SCTP-over-DTLS case takes its DTLS helpers from the DTLS cases: the
# port's SCTP cases take them from the port's DTLS cases
PORT_CASES = {"test_webrtc_dtls.py": load_cases("test_webrtc_dtls.py",
                                                port=True)}
sys.modules["_torch_webrtc_dtls_cases"] = PORT_CASES["test_webrtc_dtls.py"]
for _f in FILES[1:]:
    PORT_CASES[_f] = load_cases(_f, port=True, replace=[
        ("from tests.test_webrtc_dtls import",
         "from _torch_webrtc_dtls_cases import")])

CASES = [(f, c) for f in FILES for c in case_names(JAX_CASES[f])
         if (f, c) not in EXCLUDED]


def test_ported_cases_exist():
    assert len(CASES) == sum(len(case_names(JAX_CASES[f]))
                             for f in FILES) - len(EXCLUDED)
    for f in FILES:
        assert case_names(PORT_CASES[f]) == case_names(JAX_CASES[f])
    assert PORT_CASES["test_webrtc_pc.py"].PeerConnection is tpc.PeerConnection
    assert PORT_CASES["test_webrtc_rtp.py"].RtpPacket is trtp.RtpPacket


@pytest.mark.parametrize("file,case", CASES,
                         ids=[f"{f[12:-3]}::{c}" for f, c in CASES])
def test_webrtc_case(file, case, tmp_path, monkeypatch):
    run_case(PORT_CASES[file], case,
             {"tmp_path": tmp_path, "monkeypatch": monkeypatch})


# ------------------------------------------------------------ byte equality

J = types.SimpleNamespace(rtp=jrtp, h264=jh264, stun=jstun, sdp=jsdp,
                          srtp=jsrtp, fec=jfec, rate=jrate, ice=jice)
T = types.SimpleNamespace(rtp=trtp, h264=th264, stun=tstun, sdp=tsdp,
                          srtp=tsrtp, fec=tfec, rate=trate, ice=tice)


def _both(fn):
    """``fn`` on the JAX package's modules and on the port's."""
    got_j, got_t = fn(J), fn(T)
    assert got_j == got_t
    return got_t


def _rtp_packets(w, rng, n, ssrc=0x1234, pt=102, seq0=None):
    seq0 = int(rng.integers(0, 65536)) if seq0 is None else seq0
    ts = int(rng.integers(0, 1 << 32))
    return [w.rtp.RtpPacket(
        payload_type=pt, sequence_number=(seq0 + i) & 0xFFFF,
        timestamp=ts, ssrc=ssrc, marker=int(i == n - 1),
        payload=rng.bytes(int(rng.integers(1, 1200))),
        extensions={2: w.rtp.pack_twcc_seq(i)}) for i in range(n)]


def _rtcp_compound(w, rng):
    rr = [w.rtp.ReceiverReport(
        ssrc=int(rng.integers(0, 1 << 32)), fraction_lost=int(rng.integers(256)),
        packets_lost=int(rng.integers(1 << 20)),
        highest_sequence=int(rng.integers(1 << 32)),
        jitter=int(rng.integers(1 << 16)), lsr=int(rng.integers(1 << 32)),
        dlsr=int(rng.integers(1 << 32))) for _ in range(2)]
    base = int(rng.integers(0, 65536))
    t, received = 100 * 64000, []
    for i in range(40):
        t += int(rng.integers(0, 200)) * 250
        received.append((base + i, None if rng.random() < 0.2 else t))
    pkts = [
        w.rtp.RtcpSenderReport(
            ssrc=0x1111, ntp_time=int(rng.integers(1 << 62)),
            rtp_time=int(rng.integers(1 << 32)), packet_count=77,
            octet_count=123456, reports=rr),
        w.rtp.RtcpReceiverReport(ssrc=0x2222, reports=rr),
        w.rtp.RtcpNack(1, 0x1111, lost=sorted({int(x) for x in
                                               rng.integers(0, 200, 12)})),
        w.rtp.RtcpPli(1, 0x1111),
        w.rtp.RtcpRemb(1, int(rng.integers(150_000, 40_000_000)),
                       ssrcs=[0x1111, 0x2222]),
        w.rtp.RtcpTwcc(1, 0x1111, base_seq=base, fb_count=5, ref_time=100,
                       received=received),
    ]
    return b"".join(p.serialize() for p in pkts)


def test_rtp_and_rtcp_serialisation_equals_jax():
    def run(w):
        rng = np.random.default_rng(21)
        pkts = [p.serialize() for p in _rtp_packets(w, rng, 6)]
        compound = _rtcp_compound(w, rng)
        parsed = [(type(p).__name__, dataclasses.asdict(p))
                  for p in w.rtp.parse_rtcp(compound)]
        back = [dataclasses.asdict(w.rtp.RtpPacket.parse(p)) for p in pkts]
        return pkts, compound, parsed, back

    pkts, compound, parsed, _ = _both(run)
    assert [n for n, _ in parsed] == [
        "RtcpSenderReport", "RtcpReceiverReport", "RtcpNack", "RtcpPli",
        "RtcpRemb", "RtcpTwcc"]


def _access_unit(rng):
    nal = lambda t, n: bytes([t]) + rng.bytes(n)  # noqa: E731
    return b"".join(b"\x00\x00\x00\x01" + n for n in (
        nal(0x67, 12), nal(0x68, 4), nal(0x06, 30), nal(0x65, 5000),
        nal(0x65, 900)))


def test_h264_payloader_packets_equal_jax():
    def run(w):
        rng = np.random.default_rng(5)
        au = _access_unit(rng)
        pkts = w.h264.H264Payloader().packetize(au, 0xABCD, 102, 65530,
                                                 123456)
        dep = w.h264.H264Depayloader()
        out = [dep.feed(w.rtp.RtpPacket.parse(p.serialize())) for p in pkts]
        return [p.serialize() for p in pkts], out[-1], au

    pkts, got, au = _both(run)
    assert len(pkts) > 4 and got == au


def test_stun_messages_equal_jax():
    tid = bytes(range(12))

    def run(w):
        s = w.stun
        req = s.StunMessage(method=s.BINDING, msg_class=s.CLASS_REQUEST,
                            transaction_id=tid)
        req.set_username("remoteUfrag:localUfrag")
        req.attributes[s.ATTR_PRIORITY] = (1853817087).to_bytes(4, "big")
        req.attributes[s.ATTR_ICE_CONTROLLING] = bytes(range(8))
        req.attributes[s.ATTR_USE_CANDIDATE] = b""
        ok = s.StunMessage(method=s.BINDING, msg_class=s.CLASS_SUCCESS,
                           transaction_id=tid)
        ok.set_xor_mapped_address(("192.0.2.7", 50123))
        err = s.StunMessage(method=s.BINDING, msg_class=s.CLASS_ERROR,
                            transaction_id=tid)
        err.set_error(487, "Role Conflict")
        out = [req.serialize(integrity_key=b"pwd-of-the-peer"),
               ok.serialize(integrity_key=b"pwd"), err.serialize()]
        back = s.StunMessage.parse(out[0])
        return out, back.username(), back.verify_integrity(b"pwd-of-the-peer")

    out, user, ok = _both(run)
    assert user == "remoteUfrag:localUfrag" and ok


def test_sdp_parse_and_serialise_equal_jax():
    browser = (
        "v=0\r\no=- 77 2 IN IP4 127.0.0.1\r\ns=-\r\nt=0 0\r\n"
        "a=group:BUNDLE 0 1\r\n"
        "a=fingerprint:sha-256 " + ":".join(["AB"] * 32) + "\r\n"
        "m=video 9 UDP/TLS/RTP/SAVPF 96 97 103 104\r\n"
        "c=IN IP4 0.0.0.0\r\na=mid:0\r\na=sendrecv\r\na=rtcp-mux\r\n"
        "a=ice-ufrag:x7Zy\r\na=ice-pwd:abcdefghijklmnopqrstuv\r\n"
        "a=setup:active\r\n"
        "a=extmap:2 http://www.ietf.org/id/draft-holmer-rmcat-transport-"
        "wide-cc-extensions-01\r\n"
        "a=rtpmap:96 VP8/90000\r\na=rtpmap:97 H264/90000\r\n"
        "a=fmtp:97 level-asymmetry-allowed=1;packetization-mode=1;"
        "profile-level-id=42e01f\r\n"
        "a=rtcp-fb:97 nack pli\r\na=rtcp-fb:97 transport-cc\r\n"
        "a=rtpmap:103 red/90000\r\na=rtpmap:104 ulpfec/90000\r\n"
        "a=ssrc:42 cname:abc\r\n"
        "a=candidate:1 1 UDP 2130706431 192.168.1.4 50000 typ host\r\n"
        "a=end-of-candidates\r\n"
        "m=application 9 UDP/DTLS/SCTP webrtc-datachannel\r\n"
        "c=IN IP4 0.0.0.0\r\na=mid:1\r\na=sctp-port:5000\r\n"
        "a=max-message-size:262144\r\n")

    def run(w):
        sd = w.sdp
        offer = sd.SessionDescription(
            session_id=4242, bundle=["0", "1", "2"],
            media=[
                sd.MediaSection(
                    kind="video", mid="0", codecs=sd.default_video_codecs(),
                    ssrc=1111, cname="selkies", msid="stream track-v",
                    ice_ufrag="uf", ice_pwd="pw",
                    dtls_fingerprint="sha-256 AA:BB", dtls_setup="actpass",
                    extmap={2: "http://www.ietf.org/id/draft-holmer-rmcat-"
                               "transport-wide-cc-extensions-01"},
                    candidates=[w.ice.Candidate("f", 1, "udp", 1, "1.2.3.4",
                                                5, "host")]),
                sd.MediaSection(kind="audio", mid="1",
                                codecs=sd.default_audio_codecs(), ssrc=2222),
                sd.MediaSection(kind="application", mid="2", sctp_port=5000,
                                protocol="UDP/DTLS/SCTP",
                                max_message_size=262144)])
        text = offer.serialize()
        again = sd.SessionDescription.parse(text).serialize()
        parsed = sd.SessionDescription.parse(browser)
        return text, again, parsed.serialize(), dataclasses.asdict(parsed)

    text, again, _, parsed = _both(run)
    assert again == text
    assert [m["kind"] for m in parsed["media"]] == ["video", "application"]


def test_srtp_and_srtcp_protect_equal_jax():
    def run(w):
        rng = np.random.default_rng(9)
        key, salt = rng.bytes(16), rng.bytes(14)
        tx = w.srtp.SrtpContext(key, salt)
        # the sequence wraps inside the run: the rollover counter counts
        pkts = [p.serialize() for p in _rtp_packets(w, rng, 12, seq0=65530)]
        prot = [tx.protect_rtp(p) for p in pkts]
        rtcp = _rtcp_compound(w, rng)
        prot_rtcp = [tx.protect_rtcp(rtcp) for _ in range(3)]
        return key, salt, pkts, prot, rtcp, prot_rtcp

    key, salt, pkts, prot, rtcp, prot_rtcp = _both(run)
    # and each side reads the other's: the port unprotects these bytes
    rx = tsrtp.SrtpContext(key, salt)
    assert [rx.unprotect_rtp(p) for p in prot] == pkts
    assert [rx.unprotect_rtcp(p) for p in prot_rtcp] == [rtcp] * 3


def test_ulpfec_group_equals_jax():
    def run(w):
        rng = np.random.default_rng(13)
        enc = w.fec.UlpFecEncoder(25)
        media = [p.serialize() for p in _rtp_packets(w, rng, 8, seq0=100)]
        fec = [enc.push(m) for m in media]
        dec = w.fec.UlpFecDecoder()
        for i, m in enumerate(media[:4]):
            if i != 2:                       # lose one packet of the group
                dec.add_media(m)
        dec.add_fec(fec[3])
        recovered = dec.try_recover(0x1234)
        red = w.fec.red_wrap(102, media[0])
        return fec, recovered, red, w.fec.red_unwrap(red)

    fec, recovered, _, _ = _both(run)
    assert fec[3] is not None and fec[7] is not None
    assert len(recovered) == 1


def test_gcc_bitrate_over_one_arrival_trace_equals_jax():
    def run(w):
        rng = np.random.default_rng(17)
        gcc = w.rate.GccEstimator()
        out, send, queue = [], 0.0, 0.0
        for i in range(3000):
            send += 2.0
            # a queue that builds (overuse), drains, then stays flat
            queue = max(0.0, queue + (0.3 if 800 <= i < 1400 else
                                      -0.5 if i < 1800 else 0.0))
            arrival = send + 20.0 + queue + float(rng.normal(0, 0.2))
            out.append(gcc.add_packet(send, arrival,
                                      int(rng.integers(200, 1200))))
            if i % 250 == 249:
                out.append(gcc.add_loss_report(float(rng.random() * 0.15)))
            if i == 2000:
                out.append(gcc.feed_remb(900_000))
        received = [(k, None if k % 7 == 0 else int(k * 2100))
                    for k in range(60)]
        send_info = {k: (k * 2.0, 1000) for k in range(60)}
        out.append(gcc.feed_twcc(received, send_info))
        return out

    out = _both(run)
    assert len(set(out)) > 5                 # the estimate moved


# ------------------------------------------------------- interop on loopback


def _au(tag: int) -> bytes:
    return (b"\x00\x00\x00\x01\x67\x42\x00\x28"
            + b"\x00\x00\x00\x01\x65" + bytes([tag]) * 3000)


@pytest.mark.parametrize("offerer", ["jax", "port"])
def test_jax_and_port_peers_speak_one_wire(offerer):
    """One side a JAX PeerConnection, the other the port's: ICE, DTLS-SRTP
    and SCTP come up, and media and data-channel messages arrive intact,
    from the offerer to the answerer and back."""
    make = {"jax": jpc.PeerConnection, "port": tpc.PeerConnection}

    async def run():
        a = make[offerer](interfaces=["127.0.0.1"])
        b = make["port" if offerer == "jax" else "jax"](
            interfaces=["127.0.0.1"])
        video = a.add_video_sender(ssrc=0x1111)
        audio = a.add_audio_sender(ssrc=0x2222)
        back = b.add_video_sender(ssrc=0x3333)
        ch = a.create_data_channel("input", ordered=True)
        got_v, got_a, got_back, got_in, got_out = [], [], [], [], []
        b.video_receiver().on_frame = lambda f, ts: got_v.append((f, ts))
        b.audio_receiver().on_frame = lambda f, ts: got_a.append((f, ts))
        a.video_receiver().on_frame = lambda f, ts: got_back.append(f)
        peer_ch = {}

        def on_channel(c):
            peer_ch["ch"] = c
            c.on_message = got_in.append
        b.on_channel = on_channel
        ch.on_message = got_out.append

        offer = await a.create_offer()
        await b.set_remote_description(offer, "offer")
        answer = await b.create_answer()
        await a.set_remote_description(answer, "answer")
        await asyncio.gather(a.wait_connected(15), b.wait_connected(15))

        aus = [_au(i + 1) for i in range(6)]
        for i, au in enumerate(aus):
            video.send_frame(au, timestamp=1500 * i)
            audio.send_frame(b"opus-%d" % i, timestamp=960 * i)
            await asyncio.sleep(0.01)
        back.send_frame(_au(0xEE), timestamp=7)
        for _ in range(200):
            if len(got_v) >= 6 and len(got_a) >= 6 and got_back:
                break
            await asyncio.sleep(0.05)
        assert got_v == [(au, 1500 * i) for i, au in enumerate(aus)]
        assert got_a == [(b"opus-%d" % i, 960 * i) for i in range(6)]
        assert got_back == [_au(0xEE)]

        for _ in range(200):
            if ch.open and "ch" in peer_ch:
                break
            await asyncio.sleep(0.05)
        assert ch.open and peer_ch["ch"].label == "input"
        for msg in ("kd,65", "m,10,20,0,0", "ku,65"):
            ch.send(msg)
        b.sctp.send(peer_ch["ch"], "cursor")
        for _ in range(200):
            if len(got_in) >= 3 and got_out:
                break
            await asyncio.sleep(0.05)
        assert got_in == [b"kd,65", b"m,10,20,0,0", b"ku,65"]
        assert got_out == [b"cursor"]
        await a.close()
        await b.close()

    asyncio.run(run())
