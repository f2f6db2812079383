"""TLS on the port's REST surface and client, on the CPU: HTTPS through a
``PilosaTPUServer`` built from a config's ``[tls]`` block, mutual TLS
(a client without a certificate refused), a plaintext client refused
while the server keeps serving, an idle TCP client that never sends a
ClientHello not wedging ``accept()``, and the port's contexts answering
as ``pilosa_tpu.api.tls``'s.  Certificates are made per module with the
``cryptography`` package, as ``tests/test_tls.py`` makes them."""

import datetime
import http.client
import ipaddress
import socket

import pytest
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

cryptography = pytest.importorskip("cryptography")

from cryptography import x509  # noqa: E402
from cryptography.hazmat.primitives import hashes, serialization  # noqa: E402
from cryptography.hazmat.primitives.asymmetric import ec  # noqa: E402
from cryptography.x509.oid import NameOID  # noqa: E402

from pilosa_tpu.api import tls as jtls  # noqa: E402
from pilosa_tpu_torch.api import tls as ttls  # noqa: E402
from pilosa_tpu_torch.api.client import Client, ClientError  # noqa: E402
from pilosa_tpu_torch.cli.config import Config, load, tls_of  # noqa: E402
from pilosa_tpu_torch.server import PilosaTPUServer  # noqa: E402


def _name(cn: str) -> x509.Name:
    return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])


def _cert(cn, issuer_cert, issuer_key, *, is_ca=False):
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    b = (x509.CertificateBuilder()
         .subject_name(_name(cn))
         .issuer_name(issuer_cert.subject if issuer_cert is not None
                      else _name(cn))
         .public_key(key.public_key())
         .serial_number(x509.random_serial_number())
         .not_valid_before(now - datetime.timedelta(minutes=5))
         .not_valid_after(now + datetime.timedelta(hours=2))
         .add_extension(x509.BasicConstraints(ca=is_ca, path_length=None),
                        critical=True))
    if not is_ca:
        b = b.add_extension(x509.SubjectAlternativeName([
            x509.DNSName("localhost"),
            x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
            critical=False)
    return b.sign(issuer_key if issuer_key is not None else key,
                  hashes.SHA256()), key


def _write(tmp, name, cert, key):
    c, k = tmp / f"{name}.crt", tmp / f"{name}.key"
    c.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    k.write_bytes(key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))
    return str(c), str(k)


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pki")
    ca_cert, ca_key = _cert("port-test-ca", None, None, is_ca=True)
    node_cert, node_key = _cert("port-node", ca_cert, ca_key)
    ca = _write(tmp, "ca", ca_cert, ca_key)
    node = _write(tmp, "node", node_cert, node_key)
    return {"ca_cert": ca[0], "cert": node[0], "key": node[1]}


def _server(pki, tmp_path, client_auth=False):
    cfg = Config(bind="127.0.0.1:0", data_dir=str(tmp_path / "d"),
                 device="cpu", tls_certificate=pki["cert"],
                 tls_key=pki["key"], tls_ca_certificate=pki["ca_cert"],
                 tls_enable_client_auth=client_auth)
    return PilosaTPUServer(cfg).open()


def _client(pki, port, with_cert=True):
    tls = ttls.TLSConfig(
        certificate=pki["cert"] if with_cert else "",
        key=pki["key"] if with_cert else "",
        ca_certificate=pki["ca_cert"])
    return Client("127.0.0.1", port, ssl_context=ttls.client_context(tls))


def test_contexts_as_the_reference(pki):
    for mod in (ttls, jtls):
        assert mod.server_context(mod.TLSConfig()) is None
        assert mod.client_context(mod.TLSConfig()) is None
        assert mod.grpc_server_credentials(mod.TLSConfig()) is None
        with pytest.raises(ValueError, match="key missing"):
            mod.server_context(mod.TLSConfig(certificate=pki["cert"]))
        with pytest.raises(ValueError, match="ca_certificate"):
            mod.server_context(mod.TLSConfig(
                certificate=pki["cert"], key=pki["key"],
                enable_client_auth=True))
        skip = mod.client_context(mod.TLSConfig(skip_verify=True))
        assert not skip.check_hostname


def test_config_tls_table(pki, tmp_path):
    p = tmp_path / "c.toml"
    p.write_text(f'[tls]\ncertificate = "{pki["cert"]}"\n'
                 f'key = "{pki["key"]}"\n'
                 f'ca-certificate = "{pki["ca_cert"]}"\n'
                 "enable-client-auth = true\n")
    tls = tls_of(load(str(p), env={}))
    assert (tls.certificate, tls.key, tls.enable_client_auth) == \
        (pki["cert"], pki["key"], True)


def test_https_serves_and_plaintext_is_refused(pki, tmp_path):
    srv = _server(pki, tmp_path)
    try:
        c = _client(pki, srv.port)
        assert c.base.startswith("https://")
        c.create_index("i")
        c.create_field("i", "f")
        assert c.query("i", "Set(5, f=1)Count(Row(f=1))") == [True, 1]
        plain = Client("127.0.0.1", srv.port)
        with pytest.raises(ClientError):
            plain.version()
        # an idle client that never says hello holds its own thread only
        idle = socket.create_connection(("127.0.0.1", srv.port))
        try:
            assert c.version() == "0.1.0"
            assert c.query("i", "Count(Row(f=1))") == [1]
        finally:
            idle.close()
    finally:
        srv.close()


def test_mutual_tls(pki, tmp_path):
    srv = _server(pki, tmp_path, client_auth=True)
    try:
        assert _client(pki, srv.port).version() == "0.1.0"
        with pytest.raises(ClientError):
            _client(pki, srv.port, with_cert=False).version()
        # a raw TLS connection without a certificate gets no answer
        conn = http.client.HTTPSConnection(
            "127.0.0.1", srv.port, timeout=10, context=ttls.client_context(
                ttls.TLSConfig(ca_certificate=pki["ca_cert"])))
        with pytest.raises((OSError, http.client.HTTPException)):
            conn.request("GET", "/version")
            conn.getresponse().read()
        conn.close()
    finally:
        srv.close()
