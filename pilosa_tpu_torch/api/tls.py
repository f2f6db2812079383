"""TLS contexts for the REST surface, the HTTP client and gRPC (the
port's copy of ``pilosa_tpu.api.tls``).

One ``[tls]`` block (certificate, key, optional CA, client-certificate
verification for mutual TLS) serves every surface: the node's
certificate is presented to inbound connections and, on outbound calls,
as a client certificate.  Plaintext stays the default.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass


@dataclass(frozen=True)
class TLSConfig:
    """A resolved tls block (paths already expanded by ``cli.config.
    load``)."""

    certificate: str = ""        # PEM server/client cert path
    key: str = ""                # PEM private key path
    ca_certificate: str = ""     # PEM CA bundle for verifying peers
    skip_verify: bool = False    # client side: accept any server cert
    enable_client_auth: bool = False  # server side: require client certs

    @property
    def enabled(self) -> bool:
        return bool(self.certificate)

    def validate(self) -> None:
        if self.certificate and not self.key:
            raise ValueError("tls: certificate set but key missing")
        if self.enable_client_auth and not self.ca_certificate:
            raise ValueError(
                "tls: enable_client_auth requires ca_certificate")


def server_context(tls: TLSConfig) -> ssl.SSLContext | None:
    """SSLContext for inbound HTTP connections, or None when TLS is
    off.  ``enable_client_auth`` turns on mutual TLS: clients must
    present a certificate signed by ``ca_certificate``."""
    if not tls.enabled:
        return None
    tls.validate()
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(tls.certificate, tls.key)
    if tls.enable_client_auth:
        ctx.load_verify_locations(tls.ca_certificate)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(tls: TLSConfig) -> ssl.SSLContext | None:
    """SSLContext for outbound calls (the CLI's client), or None when TLS
    is off.  Presents the node certificate when one is configured, so a
    server that requires client certificates accepts it."""
    if not (tls.enabled or tls.ca_certificate or tls.skip_verify):
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if tls.skip_verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    elif tls.ca_certificate:
        ctx.load_verify_locations(tls.ca_certificate)
    else:
        ctx.load_default_certs()
    if tls.certificate:
        tls.validate()
        ctx.load_cert_chain(tls.certificate, tls.key)
    return ctx


def grpc_server_credentials(tls: TLSConfig):
    """``grpc.ssl_server_credentials`` built from the same block, or
    None when TLS is off."""
    if not tls.enabled:
        return None
    tls.validate()
    import grpc

    with open(tls.key, "rb") as f:
        key = f.read()
    with open(tls.certificate, "rb") as f:
        cert = f.read()
    ca = None
    if tls.ca_certificate:
        with open(tls.ca_certificate, "rb") as f:
            ca = f.read()
    return grpc.ssl_server_credentials(
        ((key, cert),), root_certificates=ca,
        require_client_auth=tls.enable_client_auth)
